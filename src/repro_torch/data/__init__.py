from .pipeline import SyntheticLM, shard_batch  # noqa: F401
