"""Size estimates for frames (``memory/estimate.py``). The device-memory
manager, spill and the external sort of the JAX package are not in this
package yet."""

from .estimate import frame_estimate, propagate_hints

__all__ = ["frame_estimate", "propagate_hints"]
