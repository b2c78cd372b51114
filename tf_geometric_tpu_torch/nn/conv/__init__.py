from .gat import *  # noqa: F401,F403
from .gcn import *  # noqa: F401,F403
from .gin import *  # noqa: F401,F403
from .graph_sage import *  # noqa: F401,F403
