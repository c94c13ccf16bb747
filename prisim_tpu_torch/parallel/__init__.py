"""Multi-device runs: the mesh on a list of torch devices."""

from .mesh import (  # noqa: F401
    make_mesh, pad_to_multiple, simulate_drift_sharded,
    simulate_drift_src_sharded, simulate_drift_nufft_sharded,
    simulate_drift_banded_sharded,
)
