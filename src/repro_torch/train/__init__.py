from .trainer import Trainer, TrainerOptions  # noqa: F401
