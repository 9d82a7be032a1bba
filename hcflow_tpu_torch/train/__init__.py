from . import losses, schedules, trainer  # noqa: F401
from .trainer import TrainState, init_state, make_optimizer  # noqa: F401
