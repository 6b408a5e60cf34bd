from .engine import Engine, Request, RoundStats  # noqa: F401
