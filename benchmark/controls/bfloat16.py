"""The control of a configuration that states float32: the reference
computed in bfloat16, the precision below, put in the program's place.
The default, for a configuration that names no `control`."""

import torch

from benchmark.harness import check


def reference_gops(pool, starts: list, gop_len: int, config: dict, device):
    """As `check.reference_gops`, in bfloat16."""
    return check.reference_gops(pool, starts, gop_len, config, device,
                                ftype=torch.bfloat16)
