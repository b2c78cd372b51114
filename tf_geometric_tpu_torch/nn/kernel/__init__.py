from .map_reduce import *  # noqa: F401,F403
from .segment import *  # noqa: F401,F403
