"""The control of a configuration whose GOPs are I-frames alone. Such a GOP
runs no float arithmetic (an integer colour transform and the integer 4x4
intra), so a lower precision changes nothing there. This control breaks a
guarantee the configuration states instead: that each 4x4 block is
predicted from the reconstruction a decoder holds (closed loop). Here each
block is predicted from the source frame's neighbours (open loop), the step
that would free the intra encoder from its serial wavefront. The frames it
gives are its own reconstruction, prediction plus dequantised residual."""

import numpy as np
import torch

from benchmark.reference import codec
from benchmark.reference import plain_ops as ops


def intra_open_loop(planes, qstep):
    """Lossy 4x4 intra of planes [G, C, H, W] (uint8), every block at once,
    predicted from the source -> (qcoef int16 [G, C, H, W], modes int8 and
    escape bool [G, C, H/4, W/4], recon uint8 [G, C, H, W])."""
    g, c, h, w = planes.shape
    nbh, nbw = h // ops.BS4, w // ops.BS4
    dev = planes.device
    orig = ops.plane_to_blocks(planes.reshape(g * c, h, w).to(torch.int32),
                               ops.BS4)
    bi = torch.arange(nbh, device=dev)[:, None].expand(nbh, nbw)
    bj = torch.arange(nbw, device=dev)[None, :].expand(nbh, nbw)
    a_u, a_l = bi >= 1, bj >= 1
    a_ul, a_ur = a_u & a_l, a_u & (bj < nbw - 1)
    up, left = (bi - 1).clamp(min=0), (bj - 1).clamp(min=0)
    right = (bj + 1).clamp(max=nbw - 1)
    fill = torch.tensor(128, dtype=torch.int32, device=dev)
    u, l, ul, ur = ops._fill(orig[:, up, bj][..., 3, :],
                             orig[:, bi, left][..., :, 3],
                             orig[:, up, left][..., 3, 3],
                             orig[:, up, right][..., 3, :],
                             a_u, a_l, a_ul, a_ur, fill)
    preds = ops._preds9(u, l, ul, ur, a_u, a_l, a_ur)
    sads = (preds - orig[None]).abs().sum(dim=(-2, -1), dtype=torch.int32)
    idx9 = torch.arange(1, 10, dtype=torch.int32, device=dev).reshape(
        9, 1, 1, 1)
    kmin = (sads * 16 + idx9).amin(dim=0)
    esc = kmin > ops.SENTINEL * 16
    mode = torch.where(esc, 0, (kmin & 15) - 1)
    pred = torch.gather(preds, 0, mode.to(torch.int64)[
        None, ..., None, None].expand(1, *mode.shape, 4, 4))[0]
    pred = torch.where((~esc)[..., None, None], pred, 0)
    gn = torch.tensor(ops._G4X400, dtype=torch.int32, device=dev)
    cf = torch.tensor(ops._CF4, dtype=torch.int32, device=dev)
    ci = torch.tensor(ops._CI4X2, dtype=torch.int32, device=dev)
    q = ops._iround_div(ops._both_sides(cf, orig - pred) * gn, 400 * qstep)
    rec = (pred + ops._iround_div(ops._both_sides(ci, q * qstep), 4)
           ).clamp(0, 255)
    out = (ops.blocks_to_plane(q).to(torch.int16), mode.to(torch.int8), esc,
           ops.blocks_to_plane(rec).to(torch.uint8))
    return tuple(x.reshape(g, c, *x.shape[1:]) for x in out)


def reference_gops(pool, starts: list, gop_len: int, config: dict, device):
    """As `check.reference_gops`, with open-loop intra; only for GOPs of an
    I-frame alone."""
    cfg = codec.Config.from_dict(config["codec"])
    if cfg.gop_pattern != ("I",):
        raise ValueError("open_loop_intra controls all-intra configurations")
    src = torch.from_numpy(np.stack([pool[s:s + gop_len] for s in starts]))
    fields, recon = codec.encode_intra_only(src.to(device), cfg,
                                            intra_open_loop)
    per_gop = [{k: v[i].cpu().numpy() for k, v in fields.items()}
               for i in range(len(starts))]
    return per_gop, recon.cpu().numpy()
