from .segment import *  # noqa: F401,F403
