"""Distribution layer (counterpart of `vcs_h264_tpu/parallel/`).

Inside one process, the (gop x tile) mesh of devices (`mesh.py`,
`spatial.py`): the GOP batch split over the gop rows, each frame's rows
over the tiles, which exchange halo rows before each search and
compensation. Across processes, the GOP axis (`distributed.py`): GOPs are
independent, so processes encode disjoint GOP spans into a shared
checkpoint directory, and rank 0 assembles the stream from it. Only
encoded artifacts cross between processes, as in the JAX package.
"""

from vcs_h264_tpu_torch.parallel.distributed import (assign_gops,
                                                     encode_distributed,
                                                     frame_range_for_gops,
                                                     init_distributed,
                                                     merge_checkpoint_dirs,
                                                     process_barrier)
from vcs_h264_tpu_torch.parallel.mesh import gop_sharding, make_mesh
from vcs_h264_tpu_torch.parallel.spatial import (sharded_decode_gop_batch,
                                                 sharded_decode_gop_batch_420,
                                                 sharded_encode_gop_batch,
                                                 sharded_encode_gop_batch_420)

__all__ = ["make_mesh", "gop_sharding",
           "sharded_encode_gop_batch", "sharded_decode_gop_batch",
           "sharded_encode_gop_batch_420", "sharded_decode_gop_batch_420",
           "assign_gops", "encode_distributed", "frame_range_for_gops",
           "init_distributed", "merge_checkpoint_dirs", "process_barrier"]
