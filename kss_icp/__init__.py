"""kss_icp — an accelerator-native point-cloud registration engine.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of KSS-ICP
(vvvwo/KSS-ICP, IEEE TIP 2023): rigid + similarity registration of 3D point
clouds via Kendall shape-space normalization, exhaustive rotation-grid coarse
alignment with local-minima multi-start, and batched ICP refinement.

Everything on the compute path is dense, padded, masked tensor math that
compiles to wide vector work on the GPU — no trees, no pointer chasing; the
hottest loops (farthest-point sampling, 1-NN) are Pallas kernels through the
Triton route. Batches of pairs and the rotation grid shard over device
meshes via jax.sharding / shard_map.
"""

from kss_icp.config import KSSICPConfig
from kss_icp.core.cloud import PointCloud
from kss_icp.core.transforms import Similarity, apply_similarity
from kss_icp.models.kss_icp import register_pair, RegistrationResult
from kss_icp.metrics import registration_measure

__version__ = "0.1.0"

__all__ = [
    "KSSICPConfig",
    "PointCloud",
    "Similarity",
    "apply_similarity",
    "register_pair",
    "RegistrationResult",
    "registration_measure",
    "__version__",
]


def register_many(*args, **kwargs):
    """Batched sweep over raw cloud pairs — see parallel/batch.register_many.
    (Lazy import: parallel/ pulls in sharding machinery.)"""
    from kss_icp.parallel.batch import register_many as _impl

    return _impl(*args, **kwargs)
