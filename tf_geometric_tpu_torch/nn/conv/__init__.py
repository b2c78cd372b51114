from .gat import *  # noqa: F401,F403
from .gcn import *  # noqa: F401,F403
from .gin import *  # noqa: F401,F403
from .graph_sage import *  # noqa: F401,F403
from .appnp import appnp, mlp_encode
from .chebynet import chebynet, chebynet_cache_normed_edge, chebynet_norm_edge
from .le_conv import le_conv
from .sgc import sgc
from .ssgc import ssgc
from .tagcn import tagcn
