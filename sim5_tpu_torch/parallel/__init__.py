"""Mesh parallelism: pixel rows and rays sharded over GPUs, distributed
init, the sharded render and the data-parallel fit step.

Port of `sim5_tpu/parallel`.
"""

from .mesh import (
    init_distributed, make_mesh, shard_image_rows, gather_rows,
    render_disk_image_sharded, loss_and_grad_sharded, fit_step_sharded,
    adam_state_from_numpy,
)
