"""Attention dispatch and the hand-written kernels with their plain versions.

Exported here: the fused GroupNorm(+SiLU) and the 3x3 NHWC conv with their
gates, under names of their own so that ``ops.group_norm`` and
``ops.conv3x3`` stay the modules. No model path calls either: ``nn.core``
keeps its own GroupNorm and Conv2d, as the JAX package's models keep XLA's.
"""

from .conv3x3 import conv3x3 as conv3x3_nhwc
from .conv3x3 import conv3x3_supported
from .group_norm import group_norm as fused_group_norm
from .group_norm import supported as group_norm_supported

__all__ = ["conv3x3_nhwc", "conv3x3_supported", "fused_group_norm", "group_norm_supported"]
