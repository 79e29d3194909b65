"""NodeStore: content-addressed object store (hash → NodeObject).

Reference scope: src/ripple_core/nodestore ({api,impl,backend}).
The pluggable Backend/Factory registry is the same seam the crypto plane
copies for `signature_backend` (nodestore/api/Factory.h:27-44). The
history shards of the JAX package's ``nodestore/shards.py`` are not part
of this package yet.
"""

from .core import (
    NodeObject,
    NodeObjectType,
    Backend,
    Database,
    register_backend,
    make_backend,
    make_database,
)
from . import backends as _backends  # noqa: F401  (registers built-ins)
from . import segstore as _segstore  # noqa: F401  (registers segstore)
from .segstore import SegStoreBackend

__all__ = [
    "NodeObject",
    "NodeObjectType",
    "Backend",
    "Database",
    "SegStoreBackend",
    "register_backend",
    "make_backend",
    "make_database",
]
