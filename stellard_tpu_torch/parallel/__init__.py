from .mesh import (
    Mesh,
    make_mesh,
    sharded_masked_sha512,
    sharded_path_quality,
    sharded_sha512_blocks,
    sharded_tree_kernels,
    sharded_verify_kernel,
    sharded_verify_kernel_pallas,
    verify_and_count,
    visible_devices,
)

__all__ = [
    "Mesh",
    "make_mesh",
    "sharded_masked_sha512",
    "sharded_path_quality",
    "sharded_sha512_blocks",
    "sharded_tree_kernels",
    "sharded_verify_kernel",
    "sharded_verify_kernel_pallas",
    "verify_and_count",
    "visible_devices",
]
