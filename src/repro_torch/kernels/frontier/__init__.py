from .ops import frontier_expand
from .ref import NBR_INF, frontier_expand_reference

__all__ = ["frontier_expand", "frontier_expand_reference", "NBR_INF"]
