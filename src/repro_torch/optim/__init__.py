from .adamw import adamw_init, adamw_update, global_norm  # noqa: F401
from .schedule import make_lr_schedule  # noqa: F401
