from .ops import attention
from .ref import mha_chunked, mha_reference

__all__ = ["attention", "mha_chunked", "mha_reference"]
