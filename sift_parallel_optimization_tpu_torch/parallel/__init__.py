"""Distributed layer on ``torch.distributed``: mesh, halo exchange, sharded
scale space, frontend, matching, BA and PGO (the JAX package's
``parallel/``)."""

from sift_parallel_optimization_tpu_torch.parallel.ba import (  # noqa: F401
    distributed_bundle_adjust,
)
from sift_parallel_optimization_tpu_torch.parallel.frontend import (  # noqa: F401
    batched_extract_features,
    gather_features,
)
from sift_parallel_optimization_tpu_torch.parallel.mesh import (  # noqa: F401
    initialize_distributed,
    make_mesh,
)
from sift_parallel_optimization_tpu_torch.parallel.matching import (  # noqa: F401
    covisibility_order,
    pairwise_match_counts,
    ring_pairwise_match_counts,
)
from sift_parallel_optimization_tpu_torch.parallel.pose_graph import (  # noqa: F401
    distributed_pgo,
)
