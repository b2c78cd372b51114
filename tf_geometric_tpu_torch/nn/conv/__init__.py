from .gcn import *  # noqa: F401,F403
