#!/usr/bin/env python3
"""Smoke run of vcs_h264_tpu_torch on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py [--seed N]
    python3 chip_smoke.py --profile     # device time by kernel, per path
    python3 chip_smoke.py --earlier DIR # also build an earlier version of
                                        # K1 to K7 (DIR holds its
                                        # motion_comp.cu, motion_sad.cu,
                                        # intra_wavefront.cu, inter_fused.cu,
                                        # inter_plane.cu + their .cuh
                                        # headers, or some of them), hold
                                        # today's kernels identical to it,
                                        # time it

Run from the root of a checkout: it builds the CUDA kernels from
`vcs_h264_tpu_torch/csrc/` with nvcc and imports nothing of JAX or of the JAX
package. Phases, each of which exits nonzero on failure:

  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
     TF32 off for matmul and cuDNN;
  2. the kernel build (one nvcc per source, all at once) and the build of
     the .vcs range coder (g++, vcs_h264_tpu_torch/csrc/bitstream.cpp),
     timed;
  3. every kernel against its plain PyTorch version on the card:
     a. K2/K3/K4 at small edge shapes (one block row, frames narrower than
        the search window, partial CTAs, one P-frame, vectors whose source
        origins fall before the top and left edges): vectors identical,
        K3/K4 within 1 on at most 2 values per shape; then K2 alone, both
        of its kernels, at the shapes its word loads, shifted window copies
        and static skip can get wrong (`search_edge_phase`): vectors
        identical; then K2 at every search geometry the JAX package runs
        (`search_geometry_phase`: G1-G5, full and long searches in the word
        kernel; G6-G8, bs 32 and 64 in the byte kernel; G9 and a bs 8 window
        of 315 KB in the direct form; 2 GOPs x 3 P-frames at 1280x720, or
        1280x704): the C entry point's form equal to
        `motion_cuda.sad_search_form`, vectors identical to the plain search
        through `motion.motion_search_gops` (which never reaches the plain
        search) and one byte off a word boundary, each form timed with its
        bound; the first 8 frames through Encoder -> .vcs -> Decoder at
        production(intra_qstep=24, search_reach=32, search_step=1) against
        the plain path (vectors identical, PSNR within 0.01 dB), and the
        CLI's encode core at --block-size 64 --no-dct against the plain
        Encoder; and K4 alone where its strips of 16 blocks, 16-byte loads
        and shifted reference words can go wrong (`fused_decode_edge_phase`:
        widths 8 to 264, one block row, one P-frame, vectors far outside and
        at the int32 extremes, coefficients at +-32767), same bound; and K3
        alone at the same shapes and vectors (`fused_encode_edge_phase`: random
        frames and frames of 0 and 255 only, whose residuals are +-255 on
        every channel; quality factors 50, 1 and 99, whose tables hold 255
        and 1), same bound;
     b. K5/K6 at small edge shapes (one 4x4 block, one or two block rows
        and columns, a ragged plane, a plane built to escape, a plane with
        more block rows than a CTA has threads; qsteps 1 to 65535): every
        output bit-identical, escapes exercised; then K6 alone on streams no
        encoder wrote (`decode_edge_phase`: random residuals, modes -3 to
        12, random and all-set escapes; 287, 288 and 289 block rows, around
        the end of the clipped decode's fast form; unclipped outputs outside
        0..255; 140 planes): identical to the plain decode;
     c. K2/K3/K4 at 1280x720, 8 GOPs of 3 P-frames: K2 vectors identical; K3
        coefficients within 1 on at most 1e-5 of them; K4 pixels within 1 on
        at most 1e-4 of them;
     d. K5/K6 on the 24 planes of the clip's 8 I-frames at 1280x720, qstep
        24: K5 qcoef, modes, escape and recon identical to the plain
        version; K6 lossy on K5's payload identical to K5's recon; K6
        lossless on the plain lossless codec's residuals identical to the
        source planes; then K5 on 8 planes and 1 of 1920 columns and 257,
        268, 270, 272 and 282 block rows (its tall form) and 283 (the
        direct form past it), identical to the plain version, K6 on its
        payload identical to its recon, timed in us a step
        (`intra_tall_phase`);
     e. K1 at edge shapes, both of its forms: bs 2, 4, 6, 8 and 16, C 1, 2
        and 3, one block row, widths that are not multiples of 32 or of 4
        and widths of 16, 48 and 1296 (the fast form), a row longer than a
        CTA's segment, vectors whose source origins fall before, after and
        far outside every edge, at every byte shift next to the last column
        and at the int32 extremes; the fast form's shapes again with refs
        one to three bytes off a word boundary and out off a 16-byte
        boundary (the general form): identical to the plain gather;
     f. K1 at the main shapes: the clip's 8 GOPs of 3 P-frames at 1280x720
        on the searched vectors, and the B shape (4 GOPs x 3 B-frames, one
        frame each): identical; timed there, at bs 4 on the 2x360x640 chroma
        planes of the 4:2:0 B path and at bs 16;
     g. the bare-plane kernels (the C = 1 case of K3/K4 on a luma plane,
        motion cells of 8 px; K7 on two chroma planes, cells of 4 px) at
        edge shapes: planes of 8x8, one block row, widths 8 to 264 around
        their strips of 16 blocks; vectors that are odd, negative, up to
        three extents outside every edge and at the int32 extremes; all-zero
        vector rows; frames of random bytes and of 0 and 255 only; quality
        factors 50, 1 and 99; coefficients as coded and at +-32767:
        identical to the plain versions; an operand off the boundary its
        wide accesses need refused with ValueError. K2 at C = 1 at an edge
        shape: vectors identical;
     h. the 4:2:0 shapes, G=8, F=3: K2 at C = 1 on the clip's 720x1280 luma
        (threshold 2000 // 3), plane_encode / plane_decode on it,
        c420_encode / c420_decode on the 2x360x640 chroma planes with the
        floor-halved vectors: identical to the plain versions; K5/K6 on the
        16 chroma I planes of 360x640: identical;
     with median times of kernel and plain version (CUDA events, after
     warm-up), each kernel's bound on this card (the larger of its bytes
     over 3.35 TB/s and its operations over 67 TFLOP/s, from this run's
     shapes and data) and, where one PyTorch call computes the same
     function, that call's time;
  4. the legacy containers (`legacy_vcs_phase`: tests/fixtures/legacy_v3.vcs
     to v10) loaded with K6 on the card and decoded there, each within +-1
     on fewer than 5e-3 of the values of its stored frames;
  5. the main paths through the user entry points, each with the launch
     counts set to 0 just before its kernel run and read just after, each
     kernel run held against the plain path's run. The kernel run of every
     path but reference mode crosses .vcs (`cross_vcs`): save_vcs and
     load_vcs three times each (median seconds), the file's bytes against
     the .npz of the same stream and its bits per pixel, no kernel launched
     by a save and K6 alone by a load, once per plane shape (1, or 2 in
     4:2:0) and GOP_CHUNK GOPs, the loaded stream identical field for field
     and its decode identical to the in-memory stream's:
     a. raw I-frames: a seeded synthetic 1280x720 clip of 34 frames (8 full
        IPPP GOPs at gop_batch 8 plus a tail GOP of I + 1 P) through
        Encoder(CodecConfig.production(), device="cuda").encode_frames ->
        save_vcs -> load_vcs -> Decoder(device="cuda").decode (the loaded
        stream identical field for field to the encoded one): K2-K4 and
        K6 (the loader's lossless intra decode) launched, P-frame PSNR
        within 0.01 dB of the plain versions;
     b. production, CodecConfig.production(intra_qstep=24), on the same
        clip: the same chain, then decode_intra_frames_lossy_batch of the
        loaded I-frame payloads, as the JAX package's bench charges it:
        K2-K6 launched, the intra decode identical to the stored I-frames,
        I-frame reconstructions, modes and qcoef identical to the plain
        path's, I- and P-frame PSNR within 0.01 dB of it;
     c. reference mode, CodecConfig(), on the same clip, through .npz
        (.vcs refuses its float coefficients): K1 and K2
        launched and neither K3 nor K4, decoded frames identical to the
        plain path's, and an encode with TF32 allowed for matmul gives
        identical coefficients;
     d. production B-frames, CodecConfig.production(intra_qstep=24,
        gop_pattern=IBPBPBP), on the same clip (4 full GOPs and a 6-frame
        tail coded all-P): K1-K6 launched, I-frame fields identical to the
        plain path's, I-, P- and B-frame PSNR within 0.01 dB of it;
     e. 4:2:0, CodecConfig.production(chroma_420=True, intra_qstep=24), on
        the same clip: K2, the bare-plane K3/K4, K7, K5 and K6 launched and
        neither full-resolution K3 nor K4; planes, vectors and payloads
        identical to the plain path's, PSNR per frame kind within 0.01 dB;
     f. 4:2:0 with B-frames, the same with gop_pattern=IBPBPBP: K1 launched
        too;
     g. the luma-only search, CodecConfig.production(intra_qstep=24,
        search_luma_only=True): K2 (at C = 1) and the full-resolution
        K3-K6;
     fps of a-c as medians of three runs, kernel and plain path
     interleaved (decoding the stream from host memory; the container's
     save and load are not timed), of d-g and of b's plain path from one
     run each.
  6. the streaming path (`stream_phase`), production with intra_qstep 24
     and gop_batch 2, so that `encode_stream` takes five chunks of 8, 8, 8,
     8 and 2 frames: its counted run is the overlapped window, encode_stream
     over an in-memory reader and Decoder.iter_frames over the stream's copy
     in host memory (pinned staging, upload and download streams), under
     torch.cuda.set_sync_debug_mode("warn"), which prints every host sync
     in it (the blocking decode is the control, which must show some), and
     the same census of encode_stream and iter_frames for each of the
     other six paths; K2-K5 launched. Then the stream equals
     encode_frames's field for field and its .vcs has the same bytes;
     iter_frames's frames are identical to decode()'s and to the blocking
     decode the port ran before its host path, from host and from device
     memory; per-GOP checkpoints:
     with 3 of the 9 files deleted, a second encode launches K2, K3 and K5
     for the missing GOPs alone and returns the same stream (host and
     device GOPs mixed, decoded to the same frames); with intra_qstep
     changed all nine are encoded again; Encoder(metrics=MetricsLogger,
     profile=True) writes 9 gop records, one encode_summary and one
     stage_timings of the stages that apply; device_trace leaves a trace
     file. VideoReader, VideoWriter, Encoder.encode_video and
     Decoder.decode_to_file need cv2, which the GPU machine lacks: the CPU
     tests (tests/test_torch_stream.py) drive them.
  7. the study functions and single-frame wrappers (`study_phase`) on one
     1280x720 frame of the clip, on the card against the same call on the
     CPU (the plain versions): luma4x4, luma16x16 and chroma8x8 (plain
     PyTorch on both), intra_encode4x4_lossy (K5) -> intra_decode4x4_lossy
     (K6), luma4x4_codec -> intra_decode4x4 (K6 unclipped, the plane back),
     motion_search and motion_search_batch (K2), motion_compensate (K1):
     integers identical; chroma_420_roundtrip +-1 on fewer than 1e-4 of
     samples, dct2_plane within 1e-3; each function's host-clock ms;
  8. the CLI's cores with no cv2 (`cli_phase`): the encode core of the main
     path into .vcs (bytes equal to Encoder -> save_vcs's, 4 695 189 at seed
     0) and the decode core of that file (frames equal to Decoder.decode's),
     their fps beside Encoder / Decoder called directly in the same call;
     the roundtrip core with profile and metrics; the encode core under
     --chroma-420 (K7 and the bare-plane pair), bytes equal to the direct
     encode's;
  9. the GOP axis across processes (`distributed_phase`): two ranks of this
     script (`--dist-rank`) on the one card meet at a store on localhost
     (gloo), encode their spans of the main path into one checkpoint
     directory, and rank 0 assembles the .vcs: both exit 0 within 180 s,
     the bytes equal the one-process .vcs, rank 0's assembling pass
     launches no K2, K3 or K5; the wall time beside the one-process encode.
     The ranks' launches are added to the kernels' record, as are phases 7,
     8, 10, 11 and 12's.
 10. the row-tiled (gop x tile) mesh (`spatial_phase`, parallel/spatial.py)
     on the clip's full GOPs, every mesh position on its own card where
     there are several, else all on cuda:0: the main path on meshes 2 x 2
     (tiles of 360 rows) and 1 x 3 (240), production B on 2 x 2, 4:2:0 on
     1 x 3. In each counted window (the sharded encode, save_vcs, load_vcs,
     the sharded decode of the loaded stream) K2, K3/K4 (or the bare-plane
     pair and K7), K5 and K6 launch on tile strips, and K1 in B; the
     sharded stream equals the unsharded port's field for field, its .vcs
     the Encoder's bytes, its decode the unsharded decode; sharded and
     unsharded encode and decode ms by CUDA events.
 11. the measurement tools (`tools_phase`, vcs_h264_tpu_torch/tools/):
     profile_stages at 1280x720 and exp_720_stages at 1280x720 and
     1920x1080 on the 640x360 synthetic clip of --seed tiled 2x2 and 3x3,
     each run as `python -m` in a process of its own: every stage's wall
     ms and queued device ms positive, device ms at most 1.05x the wall
     ms, its launches exactly the kernels its tool expects;
     bench_sustained on the clip (main path): the streamed .vcs equal to
     phase 8's bytes, every frame decoded, identical to Decoder.decode of
     the file. The tools' JSON on [tools] lines; the launches of their
     timed windows are added to the kernels' record.
 12. the bench (`bench_phase`, vcs_h264_tpu_torch/bench.py): every step
     of every key as `bench.keys` builds them (the provisional PSNR step,
     the headline, production, 720p and 1080p with and without the
     luma-only search, 4:2:0) at the bench's shapes, on the 640x360
     synthetic clip of --seed, 64 frames, tiled 2x2 and 3x3: no host sync
     in the counted call, exactly its kernels launched
     (`bench.EXPECTED_KERNELS`: reference mode K2 and K1; production K5,
     K2, K3, K4, and K6 in the intra decode loop; 4:2:0 K5, K2 at C = 1,
     the bare-plane K3/K4 and K7), its outputs within the parity contract
     of the same call on the plain versions (vectors, payloads and
     full-resolution coefficients identical, bare-plane coefficients +-1
     on < 1e-3, frames identical or +-1 on < 1e-4, the PSNR within 0.01
     dB); each step's ms and device ms over its key's iterations, the
     device ms of its rolls and of its sink alone and of the step without
     them; then `python -m
     vcs_h264_tpu_torch.bench` in a process of its own, its lines on
     [bench] lines: exit 0, the seven keys > 0 on the last line, no
     extras_error or provisional flag there, the card's name as its
     device, psnr_capped99_db finite and >= 30. The counted steps'
     launches are added to the kernels' record.
 13. the package alone (`standalone_phase`): vcs_h264_tpu_torch/ copied
     without its build/ into a temporary directory, and run there in a
     process whose import path is that directory alone, with jax,
     vcs_h264_tpu and cv2 refused: it builds its CUDA library with nvcc and
     its .vcs range coder with g++ from the copy's own csrc/, and encodes
     the clip on the card in the main path's configuration into .vcs. Exit
     0, the native coder loaded, both libraries under the copy, the CUDA
     library's name this process's, K2, K3 and K5 launched, the bytes the
     main path's (phase 8's); both build times and the wall time printed.
     Its launches are added to the kernels' record.

K2 has three forms, chosen by shape in its C entry point: the word kernel
(block sizes 4, 8, 16 on 4-byte boundaries; all main shapes), the byte
kernel (any window that fits a block's shared memory) and the direct form
(everything else); the `sad_search` entry's "geometries" lists each search
geometry's form, shared bytes, times and bound. K1 has two forms, chosen by its wrapper: the fast
form (block sizes 4, 8, 16, rows of a multiple of 16 bytes, aligned
operands; all main shapes) and the general form. The `sad_search` entry's
"earlier_ms" is the byte kernel at the main shape, reached through operands
one byte off a word boundary, and the `compensate` entry's is the general
form there, asked for by `form=`; with --earlier they are the earlier
build's times, as are those of `intra_encode`, `intra_decode`,
`fused_p_encode`, `fused_p_decode`, `plane_encode`, `plane_decode`,
`c420_encode` and `c420_decode` (null without). All ten entries carry
"redesigned": true, the kernels rebuilt since their first version; under
--earlier each of them, at every main shape and (K1, K3, K4, K6, the
bare-plane pair, K7) every edge shape, is first held identical to the
earlier build.
`intra_encode` and `intra_decode` carry "steps", the length of the chain
of dependent diagonals at the timed shape.

With --profile the script instead runs each path once on the kernels under
torch.profiler (encode, decode from host memory and the intra decode of the
payloads; no .npz), prints the host-clock time of the window, the device
time in it, its largest rows and every copy row (pageable or pinned) with
their sum, and stops without the records below.

The last two lines of standard output are the kernels' JSON record and the
device record {"ok": true, "device": {...}}; without a CUDA device the script
exits nonzero before printing either.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

H, W = 720, 1280
GOPS, P_PER_GOP = 8, 3
CLIP_FRAMES = 34
PSNR_TOL_DB = 0.01
QSTEP = 24
PAYLOAD = ("i_qcoef", "i_modes", "i_escape")
MEM_BYTES_PER_S = 3.35e12     # H100 SXM device memory (data sheet)
ALU_OPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores,
                              # taken for the integer ALU work as well
# Arithmetic per sample, counted from the algorithms: two 8-point passes of
# 8 multiplies and 8 adds each, the quantiser, and for K3/K4 the RCT; the
# 4x4 intra encode tries 9 predictors (about 3 operations per predicted
# sample and 3 per SAD term) and runs the core transform forwards and back,
# the decode one predictor and the inverse.
DCT_OPS, RCT_OPS, INTRA_ENC_OPS, INTRA_DEC_OPS = 34, 4, 94, 22
IBPBPBP = ("I", "B", "P", "B", "P", "B", "P")
B_GOPS = 4                # full IBPBPBP GOPs in the clip
TALL_H = 4 * 1024 + 8     # a plane with more block rows than any CTA's threads


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


SPIN_CYCLES = 2_000_000      # about a millisecond of an H100's clock


def time_ms(fn, reps: int, warmup: int = 2, inner: int = 1,
            spin: bool = False) -> float:
    """Median over `reps` of the time of `inner` calls between two CUDA
    events, per call. With `spin` the device first spins for about a
    millisecond, so that the events and all the calls are queued before
    the first of them starts."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if spin:
            torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return float(np.median(times))


def kernel_ms(fn, reps: int = 20) -> float:
    """A kernel wrapper's time per launch: four launches queue up behind a
    spin on the device, so the host's work before a launch (tens of
    microseconds that vary with the host and the wrapper, more than the
    smallest kernels take) is done before the first launch starts."""
    return time_ms(fn, reps, inner=4, spin=True)


def bound(n_bytes: float, n_ops: float) -> dict:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the ALU rate."""
    t_bytes = n_bytes / MEM_BYTES_PER_S * 1e3
    t_ops = n_ops / ALU_OPS_PER_S * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def coded_bound(mv, refs, data, out, rct: bool) -> dict:
    """K3/K4, their bare-plane case and K7: every operand once, and the
    transform's arithmetic on every sample."""
    return bound(nbytes(mv, refs, data, out),
                 data.numel() * (DCT_OPS + (RCT_OPS if rct else 0)))


def search_bound(curs, refs, mv, search) -> dict:
    """K2: frames in, vectors out; per block the static SAD, and for the
    blocks this run's data does not declare static the SAD of every valid
    candidate, 3 operations per sample and candidate."""
    from vcs_h264_tpu_torch.ops import motion
    g, f, c, h, w = curs.shape
    bs = search["bs"]
    plan = motion.make_plan(h, w, bs, search["reach"], search["step"])
    valid = (plan.valid_i.sum(1)[:, None] * plan.valid_j.sum(1)[None, :])
    static = (motion.static_sad(curs, refs[:, None], bs)
              <= search["static_threshold"]).cpu().numpy()
    cands = 1 + (~static) * valid[None, None]
    return bound(nbytes(curs, refs, mv), 3.0 * c * bs * bs * cands.sum())


def print_times(results: dict, shape: str, card: str) -> None:
    for name, r in results.items():
        lib = ("" if r["library_ms"] is None
               else f", one PyTorch call {r['library_ms']:.4f} ms")
        print(f"[time {name}] kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms by "
              f"{r['bound_by']}{lib}, at {shape} ({card})")


def counters():
    from vcs_h264_tpu_torch.ops import inter_cuda, intra_cuda, motion_cuda
    return (motion_cuda.LAUNCHES, inter_cuda.LAUNCHES, intra_cuda.LAUNCHES)


def reset_counts() -> None:
    for c in counters():
        for k in c:
            c[k] = 0


def read_counts() -> dict:
    return {k: v for c in counters() for k, v in c.items()}


EARLIER = None      # ctypes library of an earlier build of the kernels (--earlier)
# which of today's interfaces the earlier sources have, each by a word of
# its source: vcs_intra_encode with the quantiser's magic and shift, and
# with the form chosen by its caller (its tall form's kTallRowWarps),
# vcs_intra_decode with a scratch plane, vcs_fused_p_decode and
# vcs_fused_p_encode with their tables in host memory, vcs_compensate with
# the form chosen by its caller, the bare-plane pairs (vcs_plane_* and
# vcs_c420_*) as strips of dct_strip.cuh with their tables in host memory
EARLIER_HAS = {"magic": False, "kTallRowWarps": False, "scratch": False,
               "tabs_host": False,
               "enc_tabs_host": False, "int form": False,
               "dct_strip.cuh": False}
EARLIER_SOURCES = ("motion_sad.cu", "intra_wavefront.cu", "inter_fused.cu",
                   "motion_comp.cu", "inter_plane.cu")


def load_earlier(src_dir: str) -> None:
    """Build those of `EARLIER_SOURCES` (with the `.cuh` headers they
    include) that `src_dir` holds, an earlier version of the sources, with
    the port's nvcc flags into a second library, so that both versions are
    timed in one run on one card. Each entry point is taken with the
    interface its source has: today's, or the one it had before
    (`EARLIER_HAS`)."""
    import ctypes
    global EARLIER
    from vcs_h264_tpu_torch.ops import _build
    import hashlib
    out = _build.BUILD / ("libvcs_earlier_" + hashlib.sha256(
        os.path.abspath(src_dir).encode()).hexdigest()[:8] + ".so")
    _build.BUILD.mkdir(parents=True, exist_ok=True)
    srcs = [os.path.join(src_dir, n) for n in EARLIER_SOURCES
            if os.path.exists(os.path.join(src_dir, n))]
    if not srcs:
        fail(f"--earlier: none of {EARLIER_SOURCES} in {src_dir}")
    _build._run_all([[_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                      str(out), *srcs]])
    lib = ctypes.CDLL(str(out))
    p, i = ctypes.c_void_p, ctypes.c_int
    for key, name in (("magic", "intra_wavefront.cu"),
                      ("kTallRowWarps", "intra_wavefront.cu"),
                      ("scratch", "intra_wavefront.cu"),
                      ("tabs_host", "inter_fused.cu"),
                      ("enc_tabs_host", "inter_fused.cu"),
                      ("int form", "motion_comp.cu"),
                      ("dct_strip.cuh", "inter_plane.cu")):
        path = os.path.join(src_dir, name)
        if path in srcs:
            with open(path) as f:
                EARLIER_HAS[key] = key in f.read()
    if hasattr(lib, "vcs_sad_search"):
        lib.vcs_sad_search.argtypes = list(
            _build.SIGNATURES["vcs_sad_search"])
    if hasattr(lib, "vcs_intra_encode"):
        enc = list(_build.SIGNATURES["vcs_intra_encode"])
        lib.vcs_intra_encode.argtypes = (
            enc if EARLIER_HAS["kTallRowWarps"]
            else enc[:-2] + enc[-1:] if EARLIER_HAS["magic"]
            else [p, p, p, p, p, i, i, i, i, p])
        lib.vcs_intra_decode.argtypes = (
            list(_build.SIGNATURES["vcs_intra_decode"])
            if EARLIER_HAS["scratch"] else [p, p, p, p, i, i, i, i, i, p])
    for entry, _, _, _ in CODED.values():
        if hasattr(lib, entry):     # pointers and ints, whatever the version
            getattr(lib, entry).argtypes = list(_build.SIGNATURES[entry])
    if hasattr(lib, "vcs_compensate"):
        lib.vcs_compensate.argtypes = (
            list(_build.SIGNATURES["vcs_compensate"])
            if EARLIER_HAS["int form"] else [p, p, p, i, i, i, i, i, i, p])
    EARLIER = lib


def earlier_has(entry: str) -> bool:
    return EARLIER is not None and hasattr(EARLIER, entry)


def earlier_intra_decode(res, modes, esc, qstep: int, clip: bool):
    """A function that runs the earlier build's K6 on these operands and
    returns its output tensor."""
    import torch
    n, h, w = res.shape
    out = torch.empty((n, h, w), dtype=torch.uint8 if clip else torch.int32,
                      device=res.device)
    scratch = (torch.empty_like(res).data_ptr(),) \
        if EARLIER_HAS["scratch"] else ()
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        err = EARLIER.vcs_intra_decode(
            res.data_ptr(), modes.data_ptr(), esc.data_ptr(), out.data_ptr(),
            *scratch, n, h, w, qstep, int(clip), stream)
        if err:
            fail(f"the earlier K6 build: CUDA error {err}")
        return out
    return run


# the coded pairs, each by its wrapper and launch counter in inter_cuda:
# (entry point, the word of its source that says the earlier build takes
# its tables from host memory, output type, name)
CODED = {"fused_p_encode": ("vcs_fused_p_encode", "enc_tabs_host", "int16",
                            "K3"),
         "fused_p_decode": ("vcs_fused_p_decode", "tabs_host", "uint8", "K4"),
         "plane_encode": ("vcs_plane_encode", "dct_strip.cuh", "int16",
                          "bare-plane K3"),
         "plane_decode": ("vcs_plane_decode", "dct_strip.cuh", "uint8",
                          "bare-plane K4"),
         "c420_encode": ("vcs_c420_encode", "dct_strip.cuh", "int16",
                         "K7 encode"),
         "c420_decode": ("vcs_c420_decode", "dct_strip.cuh", "uint8",
                         "K7 decode")}


def earlier_fused(name: str, mv, refs, data, qf: float):
    """A function that runs the earlier build's kernel behind the wrapper
    `name` of `CODED` (an encode takes the frames as data, a decode the
    coefficients) on these operands and returns its output tensor."""
    import torch
    from vcs_h264_tpu_torch.ops import inter_cuda
    entry, host_key, dtype, kernel = CODED[name]
    g, f, _, h, w = data.shape
    out = torch.empty(data.shape, dtype=getattr(torch, dtype),
                      device=data.device)
    # [D, QY, QC] in host memory, or uploaded for a build from before the
    # tables became the kernels' parameter
    host = inter_cuda._tables_np(float(qf))
    dev = None if EARLIER_HAS[host_key] else torch.from_numpy(host).to(
        data.device)
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        tabs = host.ctypes.data if dev is None else dev.data_ptr()
        err = getattr(EARLIER, entry)(
            mv.data_ptr(), refs.data_ptr(), data.data_ptr(), tabs,
            out.data_ptr(), g, f, h, w, stream)
        if err:
            fail(f"the earlier {kernel} build: CUDA error {err}")
        return out
    return run


def earlier_compensate(mv, refs, bs: int):
    """A function that runs the earlier build's K1 on these operands (in
    the form today's wrapper would choose, where that build has forms) and
    returns its output tensor."""
    import torch
    from vcs_h264_tpu_torch.ops import motion_cuda
    g, c, h, w = refs.shape
    f = mv.shape[1]
    out = torch.empty((g, f, c, h, w), dtype=torch.uint8, device=refs.device)
    form = (motion_cuda.compensate_form(bs, w, refs.data_ptr(),
                                        out.data_ptr()),) \
        if EARLIER_HAS["int form"] else ()
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        err = EARLIER.vcs_compensate(mv.data_ptr(), refs.data_ptr(),
                                     out.data_ptr(), g, f, c, h, w, bs,
                                     *form, stream)
        if err:
            fail(f"the earlier K1 build: CUDA error {err}")
        return out
    return run


def earlier_decode_ms(res, modes, esc, qstep: int, clip: bool, what: str):
    """The earlier build's K6 on these operands: its time, after holding
    its output identical to today's kernel; None without --earlier."""
    import torch
    from vcs_h264_tpu_torch.ops import intra_cuda
    if not earlier_has("vcs_intra_decode"):
        return None
    run = earlier_intra_decode(res, modes, esc, qstep, clip)
    if not torch.equal(run(), intra_cuda.intra_decode(res, modes, esc, qstep,
                                                      clip)):
        fail(f"the earlier K6 build disagrees with today's kernel ({what})")
    return kernel_ms(run)


def earlier_fused_ms(name: str, mv, refs, data, qf: float, what: str):
    """The earlier build's kernel behind the wrapper `name`
    (`earlier_fused`) on these operands: its time, after holding its output
    identical to today's kernel; None without --earlier."""
    import torch
    from vcs_h264_tpu_torch.ops import inter_cuda
    entry, _, _, kernel = CODED[name]
    if not earlier_has(entry):
        return None
    run = earlier_fused(name, mv, refs, data, qf)
    if not torch.equal(run(), getattr(inter_cuda, name)(mv, refs, data, qf)):
        fail(f"the earlier {kernel} build disagrees with today's kernel "
             f"({what})")
    return kernel_ms(run)


def earlier_compensate_ms(mv, refs, bs: int, what: str):
    """The earlier build's K1 on these operands: its time, after holding
    its frames identical to today's kernel; None without --earlier."""
    import torch
    from vcs_h264_tpu_torch.ops import motion_cuda
    if not earlier_has("vcs_compensate"):
        return None
    run = earlier_compensate(mv, refs, bs)
    if not torch.equal(run(), motion_cuda.compensate(mv, refs, bs=bs)):
        fail(f"the earlier K1 build disagrees with today's kernel ({what})")
    return kernel_ms(run, 50)


def earlier_search_ms(curs, refs, search: dict):
    """The earlier build's K2 on these operands: its time, after holding
    its vectors against today's kernel; None without --earlier."""
    import torch
    from vcs_h264_tpu_torch.ops import motion_cuda
    if not earlier_has("vcs_sad_search"):
        return None
    g, f, c, h, w = curs.shape
    out = torch.empty((g, f, h // search["bs"], w // search["bs"], 2),
                      dtype=torch.int32, device=curs.device)
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        err = EARLIER.vcs_sad_search(
            curs.data_ptr(), refs.data_ptr(), out.data_ptr(), g, f, c, h, w,
            search["bs"], search["reach"], search["step"],
            search["static_threshold"], stream)
        if err:
            fail(f"the earlier K2 build: CUDA error {err}")
    run()
    if not torch.equal(out, motion_cuda.sad_search(curs, refs, **search)):
        fail("the earlier K2 build disagrees with today's kernel")
    return kernel_ms(run)


def earlier_encode_ms(planes, qstep: int):
    """The earlier build's K5 on these planes: its time, after holding
    its outputs against today's kernel; None without --earlier."""
    import torch
    if not earlier_has("vcs_intra_encode"):
        return None
    n, h, w = planes.shape
    dev = planes.device
    outs = (torch.empty((n, h, w), dtype=torch.int16, device=dev),
            torch.empty((n, h // 4, w // 4), dtype=torch.int8, device=dev),
            torch.empty((n, h // 4, w // 4), dtype=torch.bool, device=dev),
            torch.empty((n, h, w), dtype=torch.uint8, device=dev))
    stream = torch.cuda.current_stream().cuda_stream
    from vcs_h264_tpu_torch.ops import intra_cuda
    magic = intra_cuda.quant_magic(qstep) if EARLIER_HAS["magic"] else ()
    if EARLIER_HAS["kTallRowWarps"]:
        magic += (intra_cuda.encode_form(h),)

    def run():
        err = EARLIER.vcs_intra_encode(
            planes.data_ptr(), *(t.data_ptr() for t in outs), n, h, w, qstep,
            *magic, stream)
        if err:
            fail(f"the earlier K5 build: CUDA error {err}")
    run()
    if not all(torch.equal(a, b) for a, b in
               zip(outs, intra_cuda.intra_encode(planes, qstep))):
        fail("the earlier K5 build disagrees with today's kernel")
    return kernel_ms(run)


def edge_vectors(g, f, h, w, bs=8):
    """Vectors whose source origins fall before the top and left edges: -1,
    -bs and -extent-3 on each axis (and 0), in every combination, cycled
    over the blocks."""
    nbh, nbw = h // bs, w // bs
    cases = [(oj, oi) for oi in (-1, -bs, -h - 3, 0)
             for oj in (-1, -bs, -w - 3, 0)]
    n = np.arange(g * f * nbh * nbw).reshape(g, f, nbh, nbw) % len(cases)
    o = np.array(cases)[n]                                   # [g,f,nbh,nbw,2]
    o[..., 0] -= np.arange(nbw) * bs
    o[..., 1] -= np.arange(nbh)[:, None] * bs
    return o.astype(np.int32)


def edge_shape_phase() -> None:
    """Phase 3a: kernels vs plain versions at small shapes the 720p clip
    does not reach: one block row (no valid candidate row), frames narrower
    than 2*reach, block columns not a multiple of the 4 blocks a K3/K4 CTA
    holds, one P-frame per GOP, and K3/K4 on searched vectors, random
    vectors and vectors whose source origins fall before the top and left
    edges. Bound: identical vectors; coefficients and pixels within 1 on at
    most 2 values per shape and vector set (at 720p the differing fractions
    are ~1e-6, so a few thousand values see none)."""
    import torch
    from vcs_h264_tpu_torch.ops import inter_cuda, motion, motion_cuda

    rng = np.random.default_rng(2)
    for g, f, h, w in ((2, 3, 48, 72), (1, 2, 8, 64), (2, 1, 48, 24),
                       (1, 3, 40, 104)):
        refs = torch.from_numpy(
            rng.integers(0, 256, (g, 3, h, w), dtype=np.uint8)).cuda()
        curs = torch.roll(refs[:, None].expand(g, f, 3, h, w), (2, -3),
                          dims=(-2, -1)).contiguous()
        curs[:, -1] = torch.from_numpy(
            rng.integers(0, 256, (g, 3, h, w), dtype=np.uint8)).cuda()
        mv_k = motion_cuda.sad_search(curs, refs)
        mv_p = motion.motion_search_plain(curs, refs)
        if not torch.equal(mv_k, mv_p):
            fail(f"K2 vectors differ from the plain search at {(g, f, h, w)}")
        mv_r = torch.from_numpy(
            rng.integers(-16, 17, mv_p.shape, dtype=np.int32)).cuda()
        mv_e = torch.from_numpy(edge_vectors(g, f, h, w)).cuda()
        worst = []
        for mv in (mv_p, mv_r, mv_e):
            co = inter_cuda.encode_p_coeffs_plain(mv, refs, curs, 50.0)
            pairs = ((inter_cuda.fused_p_encode(mv, refs, curs, 50.0), co),
                     (inter_cuda.fused_p_decode(mv, refs, co, 50.0),
                      inter_cuda.decode_p_frames_plain(mv, refs, co, 50.0)))
            for got, want in pairs:
                d = (got.to(torch.int32) - want.to(torch.int32)).abs()
                worst.append((int(d.max()), int((d != 0).sum())))
                if worst[-1][0] > 1 or worst[-1][1] > 2:
                    fail(f"K3/K4 outside the bound at {(g, f, h, w)}: "
                         f"{worst[-1]}")
        print(f"[edge {g}x{f}x{h}x{w}] K2 vectors identical; K3/K4 "
              f"(max |diff|, count) searched/random/before-edge: {worst}")


# [G, F, H, W] where a strip of 16 blocks is partly filled or just full
FUSED_EDGE_SHAPES = ((1, 1, 8, 8), (2, 1, 16, 24), (1, 2, 8, 136),
                     (1, 3, 24, 120), (2, 2, 16, 128), (1, 1, 40, 264))


def fused_edge_vectors(rng, g, f, h, w, cell=8):
    """Three named sets of vectors on `cell`-pixel motion cells for the edge
    shapes of K3, K4 and their bare-plane pairs: in reach, with source
    origins before the top and left edges, and up to three extents outside
    with every seventh value at an int32 extreme."""
    shape = (g, f, h // cell, w // cell, 2)
    ext = 3 * max(h, w)
    far = rng.integers(-ext, ext + 1, shape)
    far.reshape(-1)[::7] = rng.choice(
        [-2**31, 2**31 - 1, -2**31 + 5, 2**31 - 9], far.reshape(-1)[::7].size)
    return (("in reach", rng.integers(-16, 17, shape)),
            ("before the edges", edge_vectors(g, f, h, w, cell)),
            ("far outside", far))


def fused_decode_edge_phase() -> None:
    """Phase 3a, K4 alone, at the shapes its strips, wide loads and shifted
    reference words can get wrong: widths of 8, 24, 136 and one strip of 128
    px less and plus 8; one block row; one P-frame; vectors in reach, vectors
    whose source origins fall before the top and left edges, vectors up to
    three extents outside and the extreme int32 values; coefficients as the
    plain encode gives them, and at +-32767. Bound: within 1 of the plain
    version on at most 2 values a case; with --earlier also identical to the
    earlier build."""
    import torch
    from vcs_h264_tpu_torch.ops import inter_cuda

    rng = np.random.default_rng(8)
    n_cases = 0
    for g, f, h, w in FUSED_EDGE_SHAPES:
        refs = torch.from_numpy(
            rng.integers(0, 256, (g, 3, h, w), dtype=np.uint8)).cuda()
        curs = torch.from_numpy(
            rng.integers(0, 256, (g, f, 3, h, w), dtype=np.uint8)).cuda()
        vectors = fused_edge_vectors(rng, g, f, h, w)
        for what, mv in vectors:
            mv = torch.from_numpy(mv.astype(np.int32)).cuda()
            coded = inter_cuda.encode_p_coeffs_plain(mv, refs, curs, 50.0)
            extreme = torch.from_numpy(rng.choice(
                np.array([-32767, 32767, 0, 0], dtype=np.int16),
                tuple(coded.shape))).cuda()
            for kind, co in (("coded", coded), ("+-32767", extreme)):
                got = inter_cuda.fused_p_decode(mv, refs, co, 50.0)
                want = inter_cuda.decode_p_frames_plain(mv, refs, co, 50.0)
                d = (got.to(torch.int32) - want.to(torch.int32)).abs()
                if int(d.max()) > 1 or int((d != 0).sum()) > 2:
                    fail(f"K4 outside the bound at {(g, f, h, w)}, vectors "
                         f"{what}, coefficients {kind}: max {int(d.max())}, "
                         f"{int((d != 0).sum())} values")
                if earlier_has("vcs_fused_p_decode") and not torch.equal(
                        earlier_fused("fused_p_decode", mv, refs, co,
                                      50.0)(), got):
                    fail(f"K4 differs from the earlier build at "
                         f"{(g, f, h, w)}, vectors {what}, coefficients "
                         f"{kind}")
                n_cases += 1
    print(f"[edge K4] {n_cases} decodes within 1 of the plain version on at "
          "most 2 values each"
          + (", identical to the earlier build"
             if earlier_has("vcs_fused_p_decode") else "")
          + ": widths 8, 24, 120, 128, 136, 264; one block row; F = 1; "
          "vectors in reach, before the edges, far outside and at the int32 "
          "extremes; coded and +-32767 coefficients")


def fused_encode_edge_phase() -> None:
    """Phase 3a, K3 alone, the mirror of `fused_decode_edge_phase`: the same
    widths (strips of 16 blocks that are partly filled, 8-byte loads and
    16-byte stores at every row of a narrow frame), one block row, one
    P-frame, the same vectors; frames of random bytes and frames of 0 and
    255 only (residuals of +-255 on every channel at once); quality factors
    50, 1 (tables of 255) and 99 (tables of 1 and 2, the largest
    coefficients). Bound: within 1 of the plain version on at most 2 values
    a case; with --earlier also identical to the earlier build."""
    import torch
    from vcs_h264_tpu_torch.ops import inter_cuda

    rng = np.random.default_rng(11)
    n_cases = 0
    for g, f, h, w in FUSED_EDGE_SHAPES:
        vectors = fused_edge_vectors(rng, g, f, h, w)
        frames = (("random", rng.integers(0, 256, (g, 3, h, w)),
                   rng.integers(0, 256, (g, f, 3, h, w))),
                  ("0 and 255", rng.choice([0, 255], (g, 1, h, w)).repeat(3, 1),
                   rng.choice([0, 255], (g, f, 1, h, w)).repeat(3, 2)))
        for kind, refs, curs in frames:
            refs = torch.from_numpy(refs.astype(np.uint8)).cuda()
            curs = torch.from_numpy(curs.astype(np.uint8)).cuda()
            for what, mv in vectors:
                mv = torch.from_numpy(mv.astype(np.int32)).cuda()
                for qf in (50.0, 1.0, 99.0):
                    got = inter_cuda.fused_p_encode(mv, refs, curs, qf)
                    want = inter_cuda.encode_p_coeffs_plain(mv, refs, curs, qf)
                    d = (got.to(torch.int32) - want.to(torch.int32)).abs()
                    if int(d.max()) > 1 or int((d != 0).sum()) > 2:
                        fail(f"K3 outside the bound at {(g, f, h, w)}, "
                             f"vectors {what}, frames {kind}, quality {qf}: "
                             f"max {int(d.max())}, {int((d != 0).sum())} "
                             "values")
                    if earlier_has("vcs_fused_p_encode") and not torch.equal(
                            earlier_fused("fused_p_encode", mv, refs, curs,
                                          qf)(), got):
                        fail(f"K3 differs from the earlier build at "
                             f"{(g, f, h, w)}, vectors {what}, frames {kind}, "
                             f"quality {qf}")
                    n_cases += 1
    print(f"[edge K3] {n_cases} encodes within 1 of the plain version on at "
          "most 2 values each"
          + (", identical to the earlier build"
             if earlier_has("vcs_fused_p_encode") else "")
          + ": widths 8, 24, 120, 128, 136, 264; one block row; F = 1; "
          "vectors in reach, before the edges, far outside and at the int32 "
          "extremes; random frames and frames of 0 and 255; quality 50, 1 "
          "and 99")


def search_case(rng, g, f, c, h, w, kind: str):
    """refs and curs for `search_edge_phase`: "static" repeats the
    reference, "moving" rolls it by (2, -3) and adds noise, "mixed"
    alternates static, moving and near-threshold frames inside each GOP and
    freezes the left half of every frame, "flat" is one value everywhere."""
    import torch
    if kind == "flat":
        refs = torch.full((g, c, h, w), 77, dtype=torch.uint8).cuda()
        return refs[:, None].expand(g, f, c, h, w).contiguous(), refs
    refs = torch.from_numpy(
        rng.integers(0, 256, (g, c, h, w), dtype=np.uint8)).cuda()
    still = refs[:, None].expand(g, f, c, h, w)
    if kind == "static":
        return still.contiguous(), refs
    noise = torch.from_numpy(
        rng.integers(-12, 13, (g, f, c, h, w)).astype(np.int16)).cuda()
    moved = (torch.roll(still, (2, -3), dims=(-2, -1)).to(torch.int16)
             + noise).clamp(0, 255).to(torch.uint8)
    if kind == "moving":
        return moved.contiguous(), refs
    curs = moved.clone()
    curs[:, 0::3] = still[:, 0::3]                       # static frames
    curs[:, 2::3] = (still[:, 2::3].to(torch.int16) + noise[:, 2::3]
                     ).clamp(0, 255).to(torch.uint8)     # near the threshold
    curs[..., :w // 2] = still[..., :w // 2]
    return curs.contiguous(), refs


def offset_view(shape, device, offset: int, align: int = 16):
    """A contiguous uint8 tensor of `shape` that starts `offset` bytes
    after an `align`-byte boundary."""
    import torch
    buf = torch.empty(int(np.prod(shape)) + offset, dtype=torch.uint8,
                      device=device)
    out = buf[offset:].view(shape)
    assert out.data_ptr() % align == offset and out.is_contiguous()
    return out


def misaligned(t, offset: int = 1):
    """A contiguous copy of uint8 `t` that starts `offset` bytes after a
    4-byte boundary: K2's entry point then takes its byte kernel, K1's
    wrapper its general form."""
    out = offset_view(t.shape, t.device, offset, 4)
    out.copy_(t)
    return out


def search_edge_phase() -> None:
    """Phase 3a, K2 alone: both kernels against the plain search, vectors
    identical. Block sizes 4, 8, 16 (word kernel) and 2, 6 (byte kernel);
    steps 1, 2, 3; reaches 5, 6, 8, 16 (5 and 6 put the window's first
    column off a word boundary); C 1, 2, 3; widths 24 to 136, so word loads
    meet the frame's edge and frames are narrower than the window; all
    blocks static, none static, and static, moving and near-threshold
    frames alternating inside a GOP (the skip is per frame, the window is
    staged per GOP); thresholds -1 (nothing static), 0, 666, 2000 and the
    maximum SAD; a flat frame, where every candidate ties and the first in
    row-major order must win; every shape again one byte off a word
    boundary (the byte kernel)."""
    import torch
    from vcs_h264_tpu_torch.ops import motion, motion_cuda

    rng = np.random.default_rng(7)
    shapes = ((2, 4, 3, 48, 72, {}), (1, 3, 1, 8, 64, {}),
              (2, 2, 3, 48, 24, {}), (1, 3, 3, 40, 136, {}),
              (1, 3, 2, 40, 40, dict(reach=8, step=2)),
              (1, 2, 3, 32, 48, dict(bs=4, reach=8, step=1)),
              (1, 2, 1, 64, 80, dict(bs=16, reach=16, step=2)),
              (1, 2, 3, 32, 64, dict(bs=16)),
              (1, 3, 3, 24, 40, dict(reach=6)),
              (1, 2, 3, 40, 104, dict(reach=5, step=1)),
              (1, 2, 1, 24, 36, dict(bs=6, reach=8, step=2)),
              (1, 2, 3, 16, 24, dict(bs=2, reach=4, step=1)))
    n = 0
    for g, f, c, h, w, kw in shapes:
        bs = kw.get("bs", 8)
        for kind in ("static", "moving", "mixed", "flat"):
            curs, refs = search_case(rng, g, f, c, h, w, kind)
            pairs = [(curs, refs), (misaligned(curs), misaligned(refs))]
            for th in (-1, 0, 2000 // 3, 2000, c * 255 * bs * bs):
                want = motion.motion_search_plain(curs, refs,
                                                  static_threshold=th, **kw)
                for cu, rf in pairs:
                    got = motion_cuda.sad_search(cu, rf, static_threshold=th,
                                                 **kw)
                    if not torch.equal(got, want):
                        fail(f"K2 differs from the plain search at "
                             f"{(g, f, c, h, w)} {kw}, {kind} frames, "
                             f"threshold {th}, operands at "
                             f"{cu.data_ptr() % 4} mod 4")
                    n += 1
    print(f"[edge K2] {n} searches identical to the plain search: word and "
          "byte kernel, bs 2-16, steps 1-3, reaches 5-16, C 1-3, widths "
          "24-136, static / moving / mixed / flat frames, thresholds -1 to "
          "the maximum")


# K2's search geometries beyond the main path's: (name, bs, reach, step, C,
# frame rows, the form of aligned operands). G1-G5 fit the word kernel, G6-G8
# the byte kernel with its shared memory opted into; G9 and G10 (a bs 8
# window of 315 KB) fit no block's shared memory and take the direct form.
# bs 32 and 64 crop the clip to 704 rows, as the CLI's reader does.
SEARCH_GEOMETRIES = (
    ("G1", 8, 32, 1, 3, H, "words"), ("G2", 8, 32, 1, 1, H, "words"),
    ("G3", 8, 64, 4, 3, H, "words"), ("G4", 4, 64, 4, 3, H, "words"),
    ("G5", 8, 64, 1, 1, H, "words"), ("G6", 32, 64, 11, 3, 704, "bytes"),
    ("G7", 64, 16, 3, 3, 704, "bytes"), ("G8", 64, 128, 21, 1, 704, "bytes"),
    ("G9", 64, 128, 21, 3, 704, "direct"),
    ("G10", 8, 160, 4, 3, H, "direct"))
GEOMETRY_GOPS = 2


def plain_calls():
    """A patch of `motion.motion_search_plain` that counts its calls
    (`.call_count`) while entered: the card's dispatcher must never reach
    it."""
    from unittest import mock
    from vcs_h264_tpu_torch.ops import motion
    return mock.patch.object(motion, "motion_search_plain",
                             wraps=motion.motion_search_plain)


def search_geometry_phase(frames, card: str):
    """Phase 3a, K2 at every search geometry the JAX package runs: at each
    of SEARCH_GEOMETRIES, 2 GOPs x 3 P-frames of the clip (C = 1: its G
    channel), the C entry point's form, shared memory and threads equal to
    `motion_cuda.sad_search_form`'s, aligned and one byte off a word
    boundary; `motion.motion_search_gops` on the card (never reaching the
    plain search) and `sad_search` on misaligned copies identical to the
    plain search, each in its expected form; each geometry timed with its
    bound. Then the first 8 frames through Encoder -> .vcs -> Decoder at
    production(intra_qstep=24, search_reach=32, search_step=1) against the
    plain path (vectors identical, PSNR within 0.01 dB, K2 launched), and
    the CLI's encode core at --block-size 64 --no-dct against the plain
    Encoder. Returns (the geometries' record, the two runs' launches)."""
    import contextlib
    import io
    import torch
    from vcs_h264_tpu_torch import CodecConfig, cli
    from vcs_h264_tpu_torch.models import Encoder
    from vcs_h264_tpu_torch.ops import motion, motion_cuda
    from vcs_h264_tpu_torch.tools.clips import ClipReader

    t_phase = time.perf_counter()
    gop_len = P_PER_GOP + 1
    clip = torch.from_numpy(np.stack(frames[:GEOMETRY_GOPS * gop_len])).cuda()
    clip = clip.permute(0, 3, 1, 2).reshape(GEOMETRY_GOPS, gop_len, 3, H, W)
    record = []
    for name, bs, reach, step, c, rows, form in SEARCH_GEOMETRIES:
        part = clip[:, :, 1:2] if c == 1 else clip
        refs = part[:, 0, :, :rows].contiguous()
        curs = part[:, 1:, :, :rows].contiguous()
        search = dict(bs=bs, reach=reach, step=step, static_threshold=2000)
        want, plain_ms = event_ms(
            lambda: motion.motion_search_plain(curs, refs, **search))
        form_off = "bytes" if form == "words" else form
        for cu, rf, expect in ((curs, refs, form),
                               (misaligned(curs), misaligned(refs), form_off)):
            aligned = (cu.data_ptr() | rf.data_ptr()) % 4 == 0
            py = motion_cuda.sad_search_form(c, bs, reach, step, aligned)
            cq = motion_cuda.sad_search_form_c(c, bs, reach, step, aligned)
            if py != cq or py[0] != expect:
                fail(f"K2's form at {name}: C {cq}, Python {py}, expected "
                     f"{expect}")
            before = dict(motion_cuda.FORMS)
            with plain_calls() as plain:
                got = motion.motion_search_gops(cu, rf, **search)
            torch.cuda.synchronize()
            took = {k: v - before[k] for k, v in motion_cuda.FORMS.items()
                    if v != before[k]}
            if plain.call_count or took != {expect: 1}:
                fail(f"K2 at {name}: the dispatcher reached the plain "
                     f"search {plain.call_count} times, forms {took}")
            if not torch.equal(got, want):
                fail(f"K2 differs from the plain search at {name} "
                     f"(operands at {cu.data_ptr() % 4} mod 4)")
        _, once = event_ms(lambda: motion_cuda.sad_search(curs, refs,
                                                            **search))
        ms = kernel_ms(lambda: motion_cuda.sad_search(curs, refs, **search),
                       20 if once < 5 else 3)
        b = search_bound(curs, refs, want, search)
        record.append(dict(name=name, bs=bs, reach=reach, step=step, c=c,
                           shape=list(curs.shape), form=form,
                           shared_bytes=motion_cuda.sad_search_form(
                               c, bs, reach, step, True)[1],
                           ms=ms, plain_ms=plain_ms, **b))
        print(f"[K2 {name}] bs {bs}, reach {reach}, step {step}, C {c}, "
              f"{list(curs.shape)}: {form} form (misaligned {form_off}), "
              f"C query = Python; "
              f"vectors identical to the plain search both ways; kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{b['bound_ms']:.4f} ms by {b['bound_by']} ({card})")

    cfg = CodecConfig.production(intra_qstep=QSTEP, search_reach=32,
                                 search_step=1)
    head = frames[:2 * cfg.gop_len]
    reset_counts()
    with plain_calls() as plain:
        dec, video, *_ = run_codec(head, "auto", cfg, container="vcs")
    launches = read_counts()
    dec_p, video_p, *_ = run_codec(head, "plain", cfg)
    same_mv = stream_diff(video, video_p)[0]
    kinds = frame_kinds(cfg, len(head))
    gaps = {k: abs(psnr_of(dec, head, [i for i in kinds if kinds[i] == k])
                   - psnr_of(dec_p, head, [i for i in kinds if kinds[i] == k]))
            for k in ("I", "P")}
    if not same_mv or max(gaps.values()) > PSNR_TOL_DB \
            or not launches["sad_search"] or plain.call_count:
        fail(f"the Encoder at reach 32, step 1: vectors identical {same_mv}, "
             f"PSNR gaps {gaps}, launches {launches}, plain search reached "
             f"{plain.call_count} times")
    print(f"[K2 encoder] production(intra_qstep={QSTEP}, search_reach=32, "
          f"search_step=1) on {len(head)} frames of {W}x{H} -> .vcs -> "
          f"Decoder: vectors identical to the plain path, PSNR gaps {gaps} "
          f"dB, launches {launches}")

    args = cli.build_parser().parse_args(
        ["encode", "clip", "-o", "out.vcs", "--block-size", "64",
         "--no-dct"])
    cfg64 = cli._cfg(args)
    cropped = [f[:H - H % 64] for f in frames]
    reset_counts()
    with tempfile.TemporaryDirectory() as tmp, plain_calls() as plain, \
            contextlib.redirect_stdout(io.StringIO()):
        video64, _, _ = cli.encode_reader(ClipReader(cropped), cfg64,
                                          os.path.join(tmp, "out.vcs"),
                                          device="cuda")
    cli_launches = read_counts()
    video64_p = Encoder(cfg64, device="cuda", backend="plain").encode_frames(
        cropped)
    if not stream_diff(video64, video64_p)[0] or plain.call_count \
            or not cli_launches["sad_search"]:
        fail(f"the CLI's encode core at --block-size 64 --no-dct: vectors "
             f"differ from the plain Encoder's, or launches {cli_launches}, "
             f"plain search reached {plain.call_count} times")
    for k, v in cli_launches.items():
        launches[k] += v
    print(f"[K2 cli] encode core at --block-size 64 --no-dct on "
          f"{len(cropped)} frames of {W}x{H - H % 64}: vectors identical to "
          f"the plain Encoder's, launches {cli_launches}; phase "
          f"{time.perf_counter() - t_phase:.1f} s ({card})")
    return record, launches


def escape_plane(h, w):
    """A plane on which lossy intra (any qstep) and the lossless codec both
    escape: the 128 border reconstructs exactly, the 0 interior then
    reconstructs exactly (DC of 128 + 128 wraps to 0), and every prediction
    of a 255 block among exact zeros is 0, so no mode beats 16 * 255."""
    bi = np.arange(h // 4)[:, None]
    bj = np.arange(w // 4)[None, :]
    blk = np.where((bi == 0) | (bj == 0), 128, 0)
    blk = np.where((bi >= 3) & (bj >= 3) & (bi % 2 == 1) & (bj % 2 == 1),
                   255, blk)
    return np.kron(blk, np.ones((4, 4), int)).astype(np.uint8)


def check_intra(planes, qstep: int, what: str, full: bool = True):
    """K5 and K6 (lossy and lossless) against their plain versions on
    uint8 planes [N, H, W] on the card: every output identical. Returns
    (K5 outputs, the lossless decode's inputs (residual, modes, escape),
    the largest |kernel - plain| of K5 and of K6). With `full` False only
    the plain encode runs: K5 against it, and K6 lossy on K5's payload
    against K5's recon; the other two returns are then None."""
    import torch
    from vcs_h264_tpu_torch.ops import intra, intra_cuda

    def err(a, b) -> int:
        if a.dtype != b.dtype or a.shape != b.shape:
            fail(f"{a.dtype} {tuple(a.shape)} against {b.dtype} "
                 f"{tuple(b.shape)} ({what})")
        return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())

    k5 = intra_cuda.intra_encode(planes, qstep)
    p5 = intra.intra_encode4x4_lossy_plain(planes, qstep)
    err5 = 0
    for name, a, b in zip(("qcoef", "modes", "escape", "recon"), k5, p5):
        err5 = max(err5, err(a, b))
        if err5:
            fail(f"K5 {name} differs from the plain version ({what})")
    k6 = intra_cuda.intra_decode(*k5[:3], qstep, True)
    if not torch.equal(k6, k5[3]):
        fail(f"K6 lossy decode differs from K5's recon ({what})")
    if not full:
        return k5, None, None
    err6 = err(k6, intra.decode_planes_plain(*k5[:3], qstep, True))
    if err6:
        fail(f"K6 lossy decode differs from the plain version ({what})")
    res, modes, esc = intra.luma4x4_codec(planes)
    lossless = (res.to(torch.int16).contiguous(), modes.to(torch.int8)
                .contiguous(), esc.contiguous())
    k6l = intra_cuda.intra_decode(*lossless, 0, False)
    err6 = max(err6, err(k6l, intra.decode_planes_plain(*lossless, 0, False)))
    if err6 or not torch.equal(k6l, planes.to(torch.int32)):
        fail(f"K6 lossless decode differs from the source planes ({what})")
    return k5, lossless, (err5, err6)


def intra_edge_phase() -> None:
    """Phase 3b: K5/K6 vs plain versions at small shapes: one block, one
    and two block rows, one and two block columns (planes taller than their
    diagonals are long), a ragged plane, qsteps from 1 to 65535 (the
    quantiser divides by multiplication), planes built to escape, and a
    plane with more block rows than a CTA has threads."""
    import torch

    rng = np.random.default_rng(3)
    for n, h, w in ((1, 4, 4), (2, 8, 64), (3, 64, 8), (2, 20, 36),
                    (2, 4, 40), (2, 48, 4), (1, 8, 8)):
        planes = torch.from_numpy(
            rng.integers(0, 256, (n, h, w), dtype=np.uint8)).cuda()
        for qstep in (8, QSTEP):
            check_intra(planes, qstep, f"{n}x{h}x{w} q{qstep}")
        for qstep in (1, 2, 255, 65535):
            check_intra(planes, qstep, f"{n}x{h}x{w} q{qstep}", full=False)
        print(f"[edge intra {n}x{h}x{w}] K5/K6 identical to plain at "
              f"qstep 8 and {QSTEP}, K6 lossless identical; K5 identical "
              "to plain and K6 to K5's recon at qsteps 1, 2, 255, 65535")
    planes = torch.from_numpy(np.stack([
        escape_plane(32, 48),
        rng.integers(0, 256, (32, 48), dtype=np.uint8)])).cuda()
    k5, lossless, _ = check_intra(planes, QSTEP, "escape planes")
    n_esc, n_esc_l = int(k5[2].sum()), int(lossless[2].sum())
    print(f"[edge intra escape 2x32x48] K5/K6 identical to plain; escapes "
          f"(escape plane and a random one): "
          f"lossy {n_esc}, lossless {n_esc_l}")
    if n_esc == 0 or n_esc_l == 0:
        fail("the escape planes did not escape")
    for n, h, w, what in (
            (1, TALL_H, 8, "more block rows than a CTA of K5 (282) or K6 "
             "(1024) has threads"),
            (40, 264, 8, "40 planes of 66 block rows, a partly filled "
             "third warp")):
        planes = torch.from_numpy(
            rng.integers(0, 256, (n, h, w), dtype=np.uint8)).cuda()
        check_intra(planes, QSTEP, f"{n}x{h}x{w}", full=False)
        print(f"[edge intra {n}x{h}x{w}] K5 identical to plain, K6 to K5's "
              f"recon ({what})")


def decode_edge_phase() -> None:
    """Phase 3b, K6 alone on streams no encoder wrote: random residuals,
    modes from -3 to 12 (those outside 0..8 predict zero) and random or
    all-set escapes, against `decode_planes_plain`, identical; with
    --earlier also identical to the earlier build. Shapes: `nbw` and `nbh` of
    1 and 2, widths that are no multiple of the 8 blocks written out
    together, planes at, one below and one above the 288 block rows where
    the clipped form's fast form ends, a plane taller than any CTA, more
    planes than the card has SMs. Forms: lossy clipped at qsteps 1, 24 and
    65535; lossless unclipped with residuals of +-255, whose outputs leave
    0..255; clipped with qstep 0 and residuals up to +-32767 (the row thread
    clamps them); unclipped with qstep 24."""
    import torch
    from vcs_h264_tpu_torch.ops import intra, intra_cuda

    rng = np.random.default_rng(9)
    fast = intra_cuda.FAST_DECODE_ROWS
    lossy, lossless = (24, True), (0, False)
    cases = (
        (2, 4, 4, (lossy, lossless)), (2, 8, 8, (lossy, lossless)),
        (3, 8, 64, ((1, True),)), (2, 4, 40, (lossy,)),
        (2, 48, 4, (lossy, lossless)),
        (2, 20, 36, (lossy, lossless, (0, True), (24, False), (65535, True))),
        (2, 64, 8, ((65535, True), (1, True))),
        (140, 8, 16, (lossy, lossless)),
        (1, 4 * (fast - 1), 12, (lossy,)),
        (1, 4 * fast, 8, (lossy, lossless, (0, True))),
        (1, 4 * (fast + 1), 8, (lossy,)),
        (1, TALL_H, 8, (lossless,)),
    )
    n_cases = 0
    for n, h, w, forms in cases:
        for qstep, clip in forms:
            for all_escape in ((False, True) if (h, w) == (20, 36)
                               else (False,)):
                if qstep:     # no int32 overflow in the inverse transform
                    amp = min(32767, 2**31 // (100 * qstep))
                else:
                    amp = 32767 if clip else 255
                res = rng.integers(-amp, amp + 1, (n, h, w))
                if not qstep and not clip:
                    res = rng.choice([-255, 255, 0], (n, h, w))
                res = torch.from_numpy(res.astype(np.int16)).cuda()
                modes = torch.from_numpy(rng.integers(
                    -3, 13, (n, h // 4, w // 4)).astype(np.int8)).cuda()
                esc = torch.from_numpy(
                    np.ones((n, h // 4, w // 4), bool) if all_escape
                    else rng.random((n, h // 4, w // 4)) < 0.1).cuda()
                got = intra_cuda.intra_decode(res, modes, esc, qstep, clip)
                want = intra.decode_planes_plain(res, modes, esc, qstep, clip)
                what = (f"{n}x{h}x{w}, qstep {qstep}, clip {clip}"
                        + (", all escape" if all_escape else ""))
                if got.dtype != want.dtype or not torch.equal(got, want):
                    fail(f"K6 differs from the plain version at {what}")
                if not clip and not qstep and not all_escape and h > 8 \
                        and 0 <= int(got.min()) and int(got.max()) <= 255:
                    fail(f"the unclipped outputs never left 0..255 ({what})")
                if earlier_has("vcs_intra_decode") and not torch.equal(
                        earlier_intra_decode(res, modes, esc, qstep, clip)(),
                        got):
                    fail(f"K6 differs from the earlier build at {what}")
                n_cases += 1
    print(f"[edge K6] {n_cases} decodes of random streams identical to the "
          "plain version"
          + (" and to the earlier build"
             if earlier_has("vcs_intra_decode") else "")
          + f": one and two block rows and columns, ragged widths, {fast - 1}"
          f", {fast} and {fast + 1} block rows, {TALL_H // 4} block rows, "
          "140 planes; lossy clipped at qsteps 1, 24, 65535, lossless "
          "unclipped at +-255, clipped at qstep 0, unclipped at qstep 24, "
          "all-escape planes, modes -3 to 12")


def smooth_planes(rng, n: int, h: int, w: int):
    """n uint8 planes [n, h, w] on the card: coarse noise scaled up
    bicubically, plus +-2 of noise, so that every mode wins somewhere."""
    import torch
    coarse = torch.from_numpy(rng.uniform(0, 255, (1, n, h // 16 + 2,
                                                   w // 16 + 2)))
    return (torch.nn.functional.interpolate(
        coarse, size=(h, w), mode="bicubic", align_corners=False)[0]
        + torch.from_numpy(rng.integers(-2, 3, (n, h, w)))
        ).clamp(0, 255).round().to(torch.uint8).cuda()


def intra_tall_phase(card: str) -> None:
    """Phase 3d, K5 on planes of 1920 columns past its staged form's 256
    block rows, a shape no path of this script drives: 257, 268 (1072 rows,
    the 1080p cells' luma), 270 (1080 rows), 272 (1088 rows, 1080p in
    16-pixel macroblocks) and the tall form's last block rows (282), each
    in the tall form, and one row past it in the direct form; 8 planes and
    the first of them alone, at qstep 24. K5's form is the one
    `intra_cuda.encode_form` names, its qcoef, modes, escape and recon are
    identical to the plain version's, and K6 on its payload returns its
    recon. Each timed, with --earlier beside the earlier build, in us a
    step."""
    import functools
    import torch
    from vcs_h264_tpu_torch.ops import intra, intra_cuda

    w, n = 1920, 8
    tall = intra_cuda.TALL_ENCODE_ROWS
    rng = np.random.default_rng(10)
    for nbh in (257, 268, 270, 272, tall, tall + 1):
        h = 4 * nbh
        form = intra_cuda.encode_form(h)
        if form != (9 if nbh <= tall else 0):
            fail(f"K5's form at {nbh} block rows is {form} row warps")
        planes = smooth_planes(rng, n, h, w)
        want = intra.intra_encode4x4_lossy_plain(planes, QSTEP)
        steps = 2 * (nbh - 1) + w // 4
        for k in (n, 1):
            sub = planes[:k]
            what = f"{k}x{h}x{w}, {nbh} block rows"
            k5 = intra_cuda.intra_encode(sub, QSTEP)
            for name, a, b in zip(("qcoef", "modes", "escape", "recon"), k5,
                                  want):
                if a.dtype != b.dtype or not torch.equal(a, b[:k]):
                    fail(f"K5 {name} differs from the plain version ({what})")
            decode = functools.partial(intra_cuda.intra_decode, *k5[:3], QSTEP,
                                       True)
            if not torch.equal(decode(), k5[3]):
                fail(f"K6 lossy decode differs from K5's recon ({what})")
            enc_ms = kernel_ms(functools.partial(intra_cuda.intra_encode, sub,
                                                 QSTEP))
            dec_ms = kernel_ms(decode)
            earlier = earlier_encode_ms(sub, QSTEP)
            print(f"[time tall intra {what}] {'tall' if form else 'direct'}"
                  f" form, identical to the plain version, K6 to K5's recon: "
                  f"K5 {enc_ms:.4f} ms, {enc_ms / steps * 1e3:.3f} us a step"
                  + ("" if earlier is None else
                     f" (the earlier build {earlier:.4f} ms, "
                     f"{earlier / steps * 1e3:.3f} us a step)")
                  + f"; K6 {dec_ms:.4f} ms; {steps} steps ({card})")


def intra_kernel_phase(planes, card: str, plain_reps: int = 3):
    """Phases 3d and 3h: K5/K6 vs plain versions on uint8 planes [N, H, W]
    on the card, with times and bounds."""
    import torch
    from vcs_h264_tpu_torch.ops import intra, intra_cuda

    n, h, w = planes.shape
    k5, lossless, (err5, err6) = check_intra(planes, QSTEP,
                                             f"{n} planes {w}x{h}")
    q, modes, esc, rec = k5
    print(f"[K5 intra_encode] qcoef, modes, escape, recon identical to the "
          f"plain version on {n} planes {w}x{h} at qstep {QSTEP}; escapes "
          f"{int(esc.sum())}, nonzero qcoef "
          f"{float((q != 0).float().mean()):.4f}")
    print("[K6 intra_decode] lossy decode identical to K5's recon; "
          "lossless decode identical to the source planes")
    steps = 2 * (h // 4 - 1) + w // 4      # the chain of dependent diagonals
    results = {
        "intra_encode": dict(
            max_abs_err=err5, steps=steps, redesigned=True,
            earlier_ms=earlier_encode_ms(planes, QSTEP),
            ms=kernel_ms(lambda: intra_cuda.intra_encode(planes, QSTEP)),
            plain_ms=time_ms(lambda: intra.intra_encode4x4_lossy_plain(
                planes, QSTEP), plain_reps, warmup=1),
            **bound(nbytes(planes, *k5), planes.numel() * INTRA_ENC_OPS),
            library_ms=None),
        "intra_decode": dict(
            max_abs_err=err6, steps=steps, redesigned=True,
            earlier_ms=earlier_decode_ms(q, modes, esc, QSTEP, True,
                                         f"lossy, {n} planes {w}x{h}"),
            ms=kernel_ms(lambda: intra_cuda.intra_decode(q, modes, esc,
                                                         QSTEP, True)),
            plain_ms=time_ms(lambda: intra.decode_planes_plain(
                q, modes, esc, QSTEP, True), plain_reps, warmup=1),
            **bound(nbytes(q, modes, esc, rec),
                    planes.numel() * INTRA_DEC_OPS),
            library_ms=None),
    }
    lossless_ms = kernel_ms(lambda: intra_cuda.intra_decode(*lossless, 0,
                                                            False))
    for name, r in results.items():
        earlier = r.get("earlier_ms")
        print(f"[time {name}] kernel {r['ms']:.4f} ms, "
              f"{r['ms'] / steps * 1e3:.3f} us for each of {steps} steps"
              + ("" if earlier is None
                 else f", the earlier build {earlier:.4f} ms")
              + f", plain {r['plain_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms by {r['bound_by']}, at N={n} {w}x{h} "
              f"qstep {QSTEP} ({card})")
    earlier = earlier_decode_ms(*lossless, 0, False,
                                f"lossless, {n} planes {w}x{h}")
    print(f"[time intra_decode lossless] kernel {lossless_ms:.4f} ms"
          + ("" if earlier is None
             else f", the earlier build {earlier:.4f} ms")
          + f" at N={n} {w}x{h} ({card})")
    return results


def search_history(curs, refs, mv_plain, search: dict, what: str,
                   card: str) -> dict:
    """K2's byte kernel at a main shape (operands one byte off a word
    boundary; the aligned ones above took the word kernel): vectors
    identical to the plain search, and its time, which is the kernel's
    time before the word kernel came. With --earlier the earlier build's
    time stands instead."""
    import torch
    from vcs_h264_tpu_torch.ops import motion_cuda
    cu, rf = misaligned(curs), misaligned(refs)
    if not torch.equal(motion_cuda.sad_search(cu, rf, **search), mv_plain):
        fail(f"K2's byte kernel differs from the plain search ({what})")
    byte_ms = kernel_ms(lambda: motion_cuda.sad_search(cu, rf, **search), 10)
    earlier = earlier_search_ms(curs, refs, search)
    print(f"[K2 sad_search, {what}] the word kernel ran at this shape; the "
          f"byte kernel, identical to the plain search too, takes "
          f"{byte_ms:.4f} ms"
          + ("" if earlier is None
             else f", the earlier build {earlier:.4f} ms") + f" ({card})")
    return dict(redesigned=True,
                earlier_ms=byte_ms if earlier is None else earlier)


def kernel_phase(frames, card: str):
    """Phase 3: kernels vs plain versions at the main path's shapes."""
    import torch
    from vcs_h264_tpu_torch import CodecConfig
    from vcs_h264_tpu_torch.ops import inter_cuda, motion, motion_cuda

    cfg = CodecConfig.production()
    qf = cfg.quality_factor
    search = dict(bs=cfg.block_size, reach=cfg.search_reach,
                  step=cfg.search_step,
                  static_threshold=cfg.static_threshold)
    gop_len = P_PER_GOP + 1
    clip = torch.from_numpy(np.stack(frames[:GOPS * gop_len])).cuda()
    clip = clip.permute(0, 3, 1, 2).reshape(GOPS, gop_len, 3, H, W)
    refs = clip[:, 0].contiguous()
    curs = clip[:, 1:].contiguous()
    results = {}

    mv_k = motion_cuda.sad_search(curs, refs, **search)
    mv_p = motion.motion_search_plain(curs, refs, **search)
    torch.cuda.synchronize()
    n_bad = int((mv_k != mv_p).any(dim=-1).sum())
    err = int((mv_k - mv_p).abs().max())
    print(f"[K2 sad_search] {n_bad} of {mv_p[..., 0].numel()} vectors differ "
          f"from the plain search (max |diff| {err}); nonzero vectors "
          f"{float((mv_p != 0).any(-1).float().mean()):.4f}")
    if n_bad:
        fail("K2 motion vectors differ from the plain version")
    results["sad_search"] = dict(
        max_abs_err=err,
        ms=kernel_ms(lambda: motion_cuda.sad_search(curs, refs, **search)),
        plain_ms=time_ms(lambda: motion.motion_search_plain(curs, refs,
                                                             **search), 5),
        **search_bound(curs, refs, mv_p, search), library_ms=None,
        **search_history(curs, refs, mv_p, search, "C 3", card))

    # K3/K4 on the searched vectors and on random in-reach vectors (the
    # latter exercise the source clamp at the frame edges)
    rng = np.random.default_rng(1)
    mv_rand = torch.from_numpy(rng.integers(
        -cfg.search_reach, cfg.search_reach + 1, mv_p.shape,
        dtype=np.int32)).cuda()
    enc_err = dec_err = 0
    for name, mv in (("searched", mv_p), ("random", mv_rand)):
        co_k = inter_cuda.fused_p_encode(mv, refs, curs, qf)
        co_p = inter_cuda.encode_p_coeffs_plain(mv, refs, curs, qf)
        d = (co_k.to(torch.int32) - co_p.to(torch.int32)).abs()
        e_max, e_frac = int(d.max()), float((d != 0).float().mean())
        dec_k = inter_cuda.fused_p_decode(mv, refs, co_p, qf)
        dec_p = inter_cuda.decode_p_frames_plain(mv, refs, co_p, qf)
        d = (dec_k.to(torch.int32) - dec_p.to(torch.int32)).abs()
        p_max, p_frac = int(d.max()), float((d != 0).float().mean())
        print(f"[K3 fused_p_encode, {name} mv] max |diff| {e_max}, "
              f"differing fraction {e_frac:.3e} (limit 1, 1e-5)")
        print(f"[K4 fused_p_decode, {name} mv] max |diff| {p_max}, "
              f"differing fraction {p_frac:.3e} (limit 1, 1e-4)")
        if e_max > 1 or e_frac > 1e-5:
            fail(f"K3 coefficients outside the bound ({name} mv)")
        if p_max > 1 or p_frac > 1e-4:
            fail(f"K4 pixels outside the bound ({name} mv)")
        enc_err, dec_err = max(enc_err, e_max), max(dec_err, p_max)
        if name == "random":      # the searched vectors' turn comes below
            earlier_fused_ms("fused_p_decode", mv, refs, co_p, qf,
                             "random vectors")
            earlier_fused_ms("fused_p_encode", mv, refs, curs, qf,
                             "random vectors")

    co = inter_cuda.encode_p_coeffs_plain(mv_p, refs, curs, qf)
    results["fused_p_encode"] = dict(
        max_abs_err=enc_err, redesigned=True,
        earlier_ms=earlier_fused_ms("fused_p_encode", mv_p, refs, curs, qf,
                                    "searched vectors"),
        ms=kernel_ms(lambda: inter_cuda.fused_p_encode(mv_p, refs, curs, qf)),
        plain_ms=time_ms(lambda: inter_cuda.encode_p_coeffs_plain(
            mv_p, refs, curs, qf), 10),
        **coded_bound(mv_p, refs, curs, co, True), library_ms=None)
    results["fused_p_decode"] = dict(
        max_abs_err=dec_err, redesigned=True,
        earlier_ms=earlier_fused_ms("fused_p_decode", mv_p, refs, co, qf,
                                    "searched vectors"),
        ms=kernel_ms(lambda: inter_cuda.fused_p_decode(mv_p, refs, co, qf)),
        plain_ms=time_ms(lambda: inter_cuda.decode_p_frames_plain(
            mv_p, refs, co, qf), 10),
        **coded_bound(mv_p, refs, co, curs, True), library_ms=None)
    print_times(results, f"G={GOPS} F={P_PER_GOP} {W}x{H}", card)
    for kernel, name in (("K3", "fused_p_encode"), ("K4", "fused_p_decode")):
        earlier = results[name]["earlier_ms"]
        if earlier is not None:
            print(f"[{kernel} {name}] identical to the earlier build on "
                  f"searched and random vectors; the earlier build takes "
                  f"{earlier:.4f} ms ({card})")
    return results


def compensate_vectors(rng, g, f, h, w, bs):
    """Two sets of vectors for K1's edge shapes: random ones up to three
    extents long, and vectors whose source origins fall at -1, -bs,
    -extent - 3, extent - bs - 3 to extent - bs + 1 (every byte shift next
    to the last start), extent and 3 * extent on each axis, every 13th at
    an int32 extreme."""
    nbh, nbw = h // bs, w // bs
    ext = 3 * max(h, w)
    mv_r = rng.integers(-ext, ext + 1, (g, f, nbh, nbw, 2))

    def along(n):
        return (-1, -bs, -n - 3, n - bs - 3, n - bs - 2, n - bs - 1, n - bs,
                n - bs + 1, n, 3 * n, 0)
    cases = [(oj, oi) for oi in along(h) for oj in along(w)]
    n = rng.permutation(g * f * nbh * nbw).reshape(g, f, nbh, nbw)
    mv_e = np.array(cases, dtype=np.int64)[n % len(cases)]
    mv_e[..., 0] -= np.arange(nbw) * bs
    mv_e[..., 1] -= np.arange(nbh)[:, None] * bs
    mv_e.reshape(-1)[::13] = rng.choice(
        [-2**31, 2**31 - 1, -2**31 + 5, 2**31 - 9],
        mv_e.reshape(-1)[::13].size)
    return mv_r.astype(np.int32), mv_e.astype(np.int32)


def compensate_edge_phase() -> None:
    """Phase 3e: K1 vs the plain gather at small shapes, identical; with
    --earlier also identical to the earlier build. Block sizes 2-16 (6 makes
    blocks straddle a segment of the general form's CTAs), C 1, 2 and 3, one
    block row, widths that are not multiples of 32 (or of 4: the byte-store
    path), a row longer than one segment, and for the fast form (bs 4, 8,
    16) widths of 16, 48 and 1296; the vectors of `compensate_vectors`. Each
    fast-form shape runs in the fast form, in the general form on the same
    operands, with refs one, two and three bytes off a word boundary and
    with out 4, 8 and 1 bytes off a 16-byte boundary: the wrapper must take
    the general form for these, and every result is the same."""
    import torch
    from vcs_h264_tpu_torch.ops import motion, motion_cuda

    rng = np.random.default_rng(4)
    fast, general = motion_cuda.FORM_FAST, motion_cuda.FORM_GENERAL
    n_form = {fast: 0, general: 0}

    def check(mv, refs, bs, want, out=None, form=None, expect=None):
        if out is None:
            out = torch.empty(want.shape, dtype=torch.uint8, device="cuda")
        chosen = motion_cuda.compensate_form(bs, refs.shape[-1],
                                             refs.data_ptr(), out.data_ptr())
        if expect is not None and chosen != expect:
            fail(f"K1's wrapper chose form {chosen}, not {expect}, at bs "
                 f"{bs}, {tuple(refs.shape)}, refs at {refs.data_ptr() % 4} "
                 f"mod 4, out at {out.data_ptr() % 16} mod 16")
        out.fill_(0x5a)
        got = motion_cuda.compensate(mv, refs, bs=bs, form=form, out=out)
        if not torch.equal(got, want):
            fail(f"K1 (form {chosen if form is None else form}) differs "
                 f"from the plain gather at bs {bs}, {tuple(refs.shape)}, "
                 f"refs at {refs.data_ptr() % 4} mod 4, out at "
                 f"{out.data_ptr() % 16} mod 16")
        n_form[chosen if form is None else form] += 1

    for bs in (2, 4, 6, 8, 16):
        shapes = [(1, 2, c, bs, 5 * bs) for c in (1, 3)]
        shapes += [(2, 3, c, 3 * bs, 7 * bs) for c in (1, 3)]
        shapes += [(1, 1, c, 2 * bs, bs * (1100 // bs + 1)) for c in (1, 3)]
        if bs in (4, 8, 16):
            shapes += [(2, 2, 1, bs, 16), (1, 3, 2, 2 * bs, 48),
                       (2, 1, 3, 3 * bs, 48), (1, 2, 3, 2 * bs, 1296)]
        for g, f, c, h, w in shapes:
            refs = torch.from_numpy(
                rng.integers(0, 256, (g, c, h, w), dtype=np.uint8)).cuda()
            takes_fast = bs in (4, 8, 16) and w % 16 == 0
            for mv in compensate_vectors(rng, g, f, h, w, bs):
                mv = torch.from_numpy(mv).cuda()
                want = motion.motion_compensate_plain(mv, refs, bs=bs)
                check(mv, refs, bs, want,
                      expect=fast if takes_fast else general)
                if earlier_has("vcs_compensate") and not torch.equal(
                        earlier_compensate(mv, refs, bs)(), want):
                    fail(f"the earlier K1 build differs from the plain "
                         f"gather at bs {bs}, {(g, f, c, h, w)}")
                if not takes_fast:
                    continue
                check(mv, refs, bs, want, form=general)
                for off in (1, 2, 3):
                    check(mv, misaligned(refs, off), bs, want, expect=general)
                for off in (4, 8, 1):
                    check(mv, refs, bs, want, expect=general,
                          out=offset_view(want.shape, "cuda", off))
        print(f"[edge compensate bs {bs}] K1 identical to the plain gather "
              "at C 1, 2 and 3, one block row, narrow and long rows, random "
              "and out-of-frame vectors, every byte shift next to the last "
              "column, int32 extremes")
    print(f"[edge compensate] {n_form[fast]} launches of the fast form, "
          f"{n_form[general]} of the general form (other block sizes and "
          "widths, asked for, refs off a word boundary, out off a 16-byte "
          "boundary), all identical to the plain gather"
          + (" and to the earlier build" if earlier_has("vcs_compensate")
             else ""))
    refs = torch.zeros((1, 1, 8, 16), dtype=torch.uint8, device="cuda")
    mv = torch.zeros((1, 1, 1, 2, 2), dtype=torch.int32, device="cuda")
    try:
        motion_cuda.compensate(mv, misaligned(refs, 1), bs=8, form=fast)
    except ValueError:
        pass
    else:
        fail("K1's wrapper let the fast form take refs off a word boundary")


def compensate_kernel_phase(frames, card: str):
    """Phase 3f: K1 vs the plain gather at the main path's shapes: the
    clip's 8 GOPs of 3 P-frames on the searched vectors (reference mode's
    shape), and the B shape, 4 GOPs x 3 B-frames of one frame each against
    their previous anchors; then at bs 4 on the B shape's 2 x 360 x 640
    chroma planes with the floor-halved vectors (the 4:2:0 B path) and at
    bs 16 on the P shape with random vectors (`with_dct=False`). Each is
    identical in the fast form the wrapper chooses, in the general form
    asked for on the same operands, and to the earlier build with
    --earlier; the general form's time, or the earlier build's, is the
    entry's "earlier_ms"."""
    import torch
    from vcs_h264_tpu_torch.models import pipeline420
    from vcs_h264_tpu_torch.ops import motion, motion_cuda

    gop_len = P_PER_GOP + 1
    clip = torch.from_numpy(np.stack(frames[:GOPS * gop_len])).cuda()
    clip = clip.permute(0, 3, 1, 2).reshape(GOPS, gop_len, 3, H, W)
    refs, curs = clip[:, 0].contiguous(), clip[:, 1:].contiguous()
    bclip = torch.from_numpy(np.stack(frames[:B_GOPS * len(IBPBPBP)])).cuda()
    bclip = bclip.permute(0, 3, 1, 2).reshape(B_GOPS, len(IBPBPBP), 3, H, W)
    b_curs = bclip[:, 1::2].reshape(-1, 1, 3, H, W).contiguous()
    b_refs = bclip[:, 0:-1:2].reshape(-1, 3, H, W).contiguous()
    mv_p = motion_cuda.sad_search(curs, refs)
    mv_b = motion_cuda.sad_search(b_curs, b_refs)
    _, c_refs = pipeline420.ingest_420(b_refs[:, None])
    rng = np.random.default_rng(12)
    mv_16 = torch.from_numpy(rng.integers(
        -16, 17, (GOPS, P_PER_GOP, H // 16, W // 16, 2),
        dtype=np.int32)).cuda()
    cases = (("P", 8, mv_p, refs), ("B", 8, mv_b, b_refs),
             ("B chroma, bs 4", 4, pipeline420._chroma_mv(mv_b),
              c_refs[:, 0].contiguous()),
             ("P, bs 16", 16, mv_16, refs))
    out = {}
    for name, bs, mv, r in cases:
        g, c, h, w = r.shape
        got = motion_cuda.compensate(mv, r, bs=bs)
        if motion_cuda.compensate_form(bs, w, r.data_ptr(), got.data_ptr()) \
                != motion_cuda.FORM_FAST:
            fail(f"K1 did not take its fast form at the {name} shape")
        want = motion.motion_compensate_plain(mv, r, bs=bs)
        general = motion_cuda.compensate(mv, r, bs=bs,
                                         form=motion_cuda.FORM_GENERAL)
        if not torch.equal(got, want) or not torch.equal(general, want):
            fail(f"K1 differs from the plain gather at the {name} shape")
        del general
        err = int((got.to(torch.int32) - want.to(torch.int32)).abs().max())
        # the one PyTorch call: torch.gather on an index built beforehand,
        # the block-major result not yet transposed back to a frame
        src, idx = motion.gather_operands(mv, r, bs)
        idx = idx.contiguous()
        if not torch.equal(
                torch.gather(src, 3, idx).reshape(*mv.shape[:2], c, h // bs,
                                                  w // bs, bs, bs)
                .transpose(-3, -2).reshape(got.shape), got):
            fail(f"torch.gather differs from K1 at the {name} shape")
        general_ms = kernel_ms(lambda: motion_cuda.compensate(
            mv, r, bs=bs, form=motion_cuda.FORM_GENERAL), 50)
        earlier = earlier_compensate_ms(mv, r, bs, f"{name} shape")
        out[name] = dict(
            max_abs_err=err, redesigned=True,
            earlier_ms=general_ms if earlier is None else earlier,
            ms=kernel_ms(lambda: motion_cuda.compensate(mv, r, bs=bs), 50),
            plain_ms=time_ms(lambda: motion.motion_compensate_plain(
                mv, r, bs=bs), 20),
            **bound(nbytes(mv, r, got), 0),
            library_ms=kernel_ms(lambda: torch.gather(src, 3, idx)))
        del src, idx
        print_times({f"compensate, {name} shape": out[name]},
                    f"G={mv.shape[0]} F={mv.shape[1]} {c}x{w}x{h} bs {bs}, "
                    "identical to the plain gather", card)
        print(f"[K1 compensate, {name} shape] the fast form ran; the general "
              f"form, identical too, takes {general_ms:.4f} ms"
              + ("" if earlier is None
                 else f", the earlier build, identical, {earlier:.4f} ms")
              + f" ({card})")
    return {"compensate": out["P"]}


def plane_vectors(rng, g, f, h, w, cell):
    """The named vector sets of `plane_edge_phase` on `cell`-pixel cells:
    those of `fused_edge_vectors`; random ones up to three extents long
    (odd and negative among them) with all-zero vector rows; and source
    origins at -1, -3, -cell, -extent - 3, extent - cell + 1, extent and
    3 * extent on each axis."""
    nh, nw = h // cell, w // cell
    ext = 3 * max(h, w)
    mv_r = rng.integers(-ext, ext + 1, (g, f, nh, nw, 2))
    mv_r[:, :, ::2] = 0                      # all-zero vector rows
    cases = [(oj, oi)
             for oi in (-1, -3, -cell, -h - 3, h - cell + 1, h, 3 * h, 0)
             for oj in (-1, -3, -cell, -w - 3, w - cell + 1, w, 3 * w, 0)]
    n = np.arange(g * f * nh * nw).reshape(g, f, nh, nw)
    mv_e = np.array(cases)[n % len(cases)]
    mv_e[..., 0] -= np.arange(nw) * cell
    mv_e[..., 1] -= np.arange(nh)[:, None] * cell
    return fused_edge_vectors(rng, g, f, h, w, cell) + (
        ("random with zero rows", mv_r), ("at the edges", mv_e))


def shifted_copy(t, elements: int = 1):
    """A contiguous copy of `t` that starts `elements` of its elements after
    the allocator's boundary (one byte for uint8)."""
    import torch
    buf = torch.empty(t.numel() + elements, dtype=t.dtype, device=t.device)
    out = buf[elements:].view(t.shape)
    out.copy_(t)
    return out


def plane_edge_phase() -> None:
    """Phase 3g: the bare-plane kernels vs their plain versions at small
    shapes, identical; with --earlier also identical to the earlier build.
    The luma pair (C 1, motion cells of 8) and the chroma pair (C 2, cells
    of 4) on planes of 8x8, one block row, widths 8 to 264 around the strip
    of 16 blocks (`FUSED_EDGE_SHAPES`) and partial strips; the vectors of
    `plane_vectors` (in reach, before the edges, up to three extents outside
    and at the int32 extremes, random with all-zero rows, at the edges);
    frames of random bytes and frames of 0 and 255 only; qualities 50, 1
    and 99; the decode on the coefficients as coded and at +-32767. Each
    wrapper refuses an operand off the boundary its wide accesses need
    (`inter_cuda._ALIGNMENTS`) with ValueError before any launch. Then K2
    at C = 1 against the plain search at the threshold 2000 // 3."""
    import torch
    from vcs_h264_tpu_torch.ops import inter_cuda, motion, motion_cuda

    rng = np.random.default_rng(5)
    pairs = (("plane", 1, 8, inter_cuda.encode_p_coeffs_plain,
              inter_cuda.decode_p_frames_plain),
             ("c420", 2, 4, inter_cuda.encode_c420_coeffs_plain,
              inter_cuda.decode_c420_frames_plain))
    shapes = ((1, 1, 8, 8), (2, 3, 8, 72), (1, 2, 24, 40), (2, 1, 48, 104),
              (1, 3, 16, 136)) + FUSED_EDGE_SHAPES
    for name, c, cell, enc_plain, dec_plain in pairs:
        enc = getattr(inter_cuda, f"{name}_encode")
        dec = getattr(inter_cuda, f"{name}_decode")
        earlier = earlier_has(CODED[f"{name}_encode"][0])
        n_enc = n_dec = 0
        for g, f, h, w in shapes:
            vectors = plane_vectors(rng, g, f, h, w, cell)
            frames = (("random", rng.integers(0, 256, (g, c, h, w)),
                       rng.integers(0, 256, (g, f, c, h, w))),
                      ("0 and 255", rng.choice([0, 255], (g, c, h, w)),
                       rng.choice([0, 255], (g, f, c, h, w))))
            extreme = torch.from_numpy(rng.choice(
                np.array([-32767, 32767, 0, 0], dtype=np.int16),
                (g, f, c, h, w))).cuda()
            for kind, refs, curs in frames:
                refs = torch.from_numpy(refs.astype(np.uint8)).cuda()
                curs = torch.from_numpy(curs.astype(np.uint8)).cuda()
                for what, mv in vectors:
                    mv = torch.from_numpy(mv.astype(np.int32)).cuda()
                    for qf in (50.0, 1.0, 99.0):
                        case = (f"{(g, f, c, h, w)}, vectors {what}, frames "
                                f"{kind}, quality {qf}")
                        co = enc_plain(mv, refs, curs, qf)
                        got = enc(mv, refs, curs, qf)
                        if not torch.equal(got, co):
                            fail(f"{name}_encode differs from its plain "
                                 f"version at {case}")
                        if earlier and not torch.equal(earlier_fused(
                                f"{name}_encode", mv, refs, curs, qf)(), got):
                            fail(f"{name}_encode differs from the earlier "
                                 f"build at {case}")
                        n_enc += 1
                        for co_kind, coefs in (("coded", co),
                                               ("+-32767", extreme)):
                            got = dec(mv, refs, coefs, qf)
                            if not torch.equal(
                                    got, dec_plain(mv, refs, coefs, qf)):
                                fail(f"{name}_decode differs from its plain "
                                     f"version at {case}, coefficients "
                                     f"{co_kind}")
                            if earlier and not torch.equal(earlier_fused(
                                    f"{name}_decode", mv, refs, coefs,
                                    qf)(), got):
                                fail(f"{name}_decode differs from the "
                                     f"earlier build at {case}, "
                                     f"coefficients {co_kind}")
                            n_dec += 1
        print(f"[edge {name}_encode / {name}_decode, C {c}, cells of {cell}] "
              f"{n_enc} encodes and {n_dec} decodes identical to the plain "
              "versions" + (" and to the earlier build" if earlier else "")
              + ": 8x8, one block row, widths 8 to 264, F = 1; vectors in "
              "reach, before the edges, far outside, int32 extremes, random "
              "with zero rows, at the edges; random frames and frames of 0 "
              "and 255; quality 50, 1, 99; coded and +-32767 coefficients")

        # an operand off its boundary: ValueError, and no launch
        g, f, h, w = 1, 2, 8, 16
        mv = torch.zeros((g, f, h // cell, w // cell, 2), dtype=torch.int32,
                         device="cuda")
        refs = torch.zeros((g, c, h, w), dtype=torch.uint8, device="cuda")
        curs = torch.zeros((g, f, c, h, w), dtype=torch.uint8, device="cuda")
        co = torch.zeros((g, f, c, h, w), dtype=torch.int16, device="cuda")
        before = dict(inter_cuda.LAUNCHES)
        for fn, args in ((enc, (mv, refs, curs)), (dec, (mv, refs, co))):
            for i in range(3):
                bad = list(args)
                bad[i] = shifted_copy(args[i])
                try:
                    fn(*bad, 50.0)
                except ValueError as e:
                    if "boundary" not in str(e):
                        fail(f"{fn.__name__} refused operand {i} off its "
                             f"boundary for another reason: {e}")
                else:
                    fail(f"{fn.__name__} took operand {i} "
                         f"{bad[i].data_ptr() % 16} bytes off a 16-byte "
                         "boundary")
        if inter_cuda.LAUNCHES != before:
            fail(f"{name}: a refused operand was launched on")
        print(f"[edge {name}_encode / {name}_decode] mv, refs and "
              "curs / coefficients one element off their boundary refused "
              "with ValueError before any launch")
    for g, f, h, w in ((2, 3, 48, 72), (1, 2, 8, 64), (2, 1, 48, 24)):
        refs = torch.from_numpy(
            rng.integers(0, 256, (g, 1, h, w), dtype=np.uint8)).cuda()
        curs = torch.roll(refs[:, None].expand(g, f, 1, h, w), (2, -3),
                          dims=(-2, -1)).contiguous()
        curs[:, -1] = (refs.to(torch.int16) + torch.from_numpy(
            rng.integers(-12, 13, (g, 1, h, w)).astype(np.int16)).cuda()
            ).clamp(0, 255).to(torch.uint8)          # near the threshold
        for th in (2000 // 3, 0, 64 * 255):
            if not torch.equal(
                    motion_cuda.sad_search(curs, refs, static_threshold=th),
                    motion.motion_search_plain(curs, refs,
                                               static_threshold=th)):
                fail(f"K2 at C = 1 differs from the plain search at "
                     f"{(g, f, h, w)}, threshold {th}")
    print("[edge K2, C 1] vectors identical to the plain search at "
          "thresholds 666, 0 and 16320")


def plane_kernel_phase(frames, card: str):
    """Phase 3h: the 4:2:0 kernels vs their plain versions at the main
    path's shapes, the clip's 8 GOPs of 3 P-frames ingested to planes."""
    import torch
    from vcs_h264_tpu_torch import CodecConfig
    from vcs_h264_tpu_torch.models import pipeline420
    from vcs_h264_tpu_torch.ops import inter_cuda, motion, motion_cuda

    cfg = CodecConfig.production(chroma_420=True, intra_qstep=QSTEP)
    qf = cfg.quality_factor
    search = dict(bs=cfg.block_size, reach=cfg.search_reach,
                  step=cfg.search_step,
                  static_threshold=cfg.static_threshold // 3)
    gop_len = P_PER_GOP + 1
    clip = torch.from_numpy(np.stack(frames[:GOPS * gop_len])).cuda()
    y, c = pipeline420.ingest_420(
        clip.permute(0, 3, 1, 2).reshape(GOPS, gop_len, 3, H, W))
    y_ref, y_cur = y[:, :1].contiguous(), y[:, 1:, None].contiguous()
    c_ref, c_cur = c[:, 0].contiguous(), c[:, 1:].contiguous()

    mv = motion_cuda.sad_search(y_cur, y_ref, **search)
    mv_p = motion.motion_search_plain(y_cur, y_ref, **search)
    if not torch.equal(mv, mv_p):
        fail("K2 at C = 1 differs from the plain search at 720p")
    k2 = dict(ms=kernel_ms(lambda: motion_cuda.sad_search(y_cur, y_ref,
                                                          **search)),
              plain_ms=time_ms(lambda: motion.motion_search_plain(
                  y_cur, y_ref, **search), 5),
              **search_bound(y_cur, y_ref, mv, search), library_ms=None,
              **search_history(y_cur, y_ref, mv_p, search, "C 1", card))
    print(f"[K2 sad_search, C 1] vectors identical to the plain search; "
          f"nonzero vectors {float((mv != 0).any(-1).float().mean()):.4f}")
    print_times({"sad_search, C 1": k2}, f"G={GOPS} F={P_PER_GOP} {W}x{H}",
                card)

    mv_c = pipeline420._chroma_mv(mv)
    rng = np.random.default_rng(6)
    mv_rand = torch.from_numpy(rng.integers(
        -cfg.search_reach, cfg.search_reach + 1, mv.shape,
        dtype=np.int32)).cuda()
    results = {}
    cases = (("plane", mv, mv_rand, y_ref, y_cur, inter_cuda.plane_encode,
              inter_cuda.plane_decode, inter_cuda.encode_p_coeffs_plain,
              inter_cuda.decode_p_frames_plain),
             ("c420", mv_c, pipeline420._chroma_mv(mv_rand), c_ref, c_cur,
              inter_cuda.c420_encode, inter_cuda.c420_decode,
              inter_cuda.encode_c420_coeffs_plain,
              inter_cuda.decode_c420_frames_plain))
    for name, v, v_rand, refs, curs, enc, dec, enc_plain, dec_plain in cases:
        for what, vec in (("searched", v), ("random", v_rand)):
            co = enc_plain(vec, refs, curs, qf)
            if not torch.equal(enc(vec, refs, curs, qf), co):
                fail(f"{name}_encode differs from its plain version "
                     f"({what} vectors)")
            if not torch.equal(dec(vec, refs, co, qf),
                               dec_plain(vec, refs, co, qf)):
                fail(f"{name}_decode differs from its plain version "
                     f"({what} vectors)")
            if what == "random":      # the searched vectors' turn comes below
                earlier_fused_ms(f"{name}_encode", vec, refs, curs, qf,
                                 "random vectors")
                earlier_fused_ms(f"{name}_decode", vec, refs, co, qf,
                                 "random vectors")
        co = enc_plain(v, refs, curs, qf)
        results[f"{name}_encode"] = dict(
            max_abs_err=0, redesigned=True,
            earlier_ms=earlier_fused_ms(f"{name}_encode", v, refs, curs, qf,
                                        "searched vectors"),
            ms=kernel_ms(lambda: enc(v, refs, curs, qf)),
            plain_ms=time_ms(lambda: enc_plain(v, refs, curs, qf), 10),
            **coded_bound(v, refs, curs, co, False), library_ms=None)
        results[f"{name}_decode"] = dict(
            max_abs_err=0, redesigned=True,
            earlier_ms=earlier_fused_ms(f"{name}_decode", v, refs, co, qf,
                                        "searched vectors"),
            ms=kernel_ms(lambda: dec(v, refs, co, qf)),
            plain_ms=time_ms(lambda: dec_plain(v, refs, co, qf), 10),
            **coded_bound(v, refs, co, curs, False), library_ms=None)
        print(f"[{name}_encode / {name}_decode] identical to the plain "
              f"versions on searched and random vectors at "
              f"{tuple(curs.shape)}; nonzero coefficients "
              f"{float((co != 0).float().mean()):.4f}")
    print_times(results, f"G={GOPS} F={P_PER_GOP}, luma {W}x{H}, chroma "
                f"2x{W // 2}x{H // 2}", card)
    for name, r in results.items():
        if r["earlier_ms"] is not None:
            print(f"[{name}] identical to the earlier build on searched and "
                  f"random vectors; the earlier build takes "
                  f"{r['earlier_ms']:.4f} ms ({card})")

    # K5/K6 on the chroma I planes: 16 planes of 360x640, 90 block rows
    intra_kernel_phase(c_ref.reshape(-1, H // 2, W // 2), card, plain_reps=1)
    return results


def container_of(cfg) -> str:
    """The container a path's checked run crosses: .vcs, or .npz for a
    reference-mode stream (float coefficients), which .vcs refuses."""
    return "npz" if cfg.with_dct and cfg.quant_mode == "reference" else "vcs"


def same_fields(video, loaded, what: str) -> None:
    """Fail unless the loaded stream is the encoded one field for field."""
    import dataclasses
    import torch
    for g, (a, b) in enumerate(zip(video.gops, loaded.gops)):
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if (x is None) != (y is None) or (
                    x is not None and not torch.equal(x.cpu(), y.cpu())):
                fail(f"{what} changed the stream (GOP {g}, {f.name})")


def cross_vcs(video, path: str, backend: str, report=None):
    """save_vcs, then load_vcs decoding the intra I-frames with `backend`;
    fails if the save launches a kernel or the load one other than K6.
    With `report` = (label, card): each three times, and fails unless every
    load launches K6 once per plane shape and GOP_CHUNK GOPs; prints the
    median seconds, the K6 launches per load and the file's bytes against
    the .npz of the same stream. Returns the loaded stream."""
    from vcs_h264_tpu_torch.io import bitstream

    t_save, t_load, k6 = [], [], []
    for _ in range(3 if report else 1):
        c0 = read_counts()
        t0 = time.perf_counter()
        bitstream.save_vcs(video, path)
        t1 = time.perf_counter()
        c1 = read_counts()
        loaded = bitstream.load_vcs(path, backend=backend)
        t2 = time.perf_counter()
        c2 = read_counts()
        t_save.append(t1 - t0)
        t_load.append(t2 - t1)
        if c1 != c0:
            fail(f"save_vcs launched kernels: {c0} -> {c1}")
        d = {k: c2[k] - c1[k] for k in c2}
        k6.append(d.pop("intra_decode"))
        if any(d.values()):
            fail(f"load_vcs launched {d}")
    if report is None:
        return loaded
    label, card = report
    cfg = video.config
    batches = -(-len(video.gops) // bitstream.GOP_CHUNK)
    want = ((2 if cfg.chroma_420 else 1) if cfg.intra_i else 0) * batches
    if k6 != [want] * 3:
        fail(f"load_vcs made {k6} K6 launches, not {want} per load "
             f"({label})")
    vcs_bytes = os.path.getsize(path)
    npz = path[:-len(".vcs")] + ".npz"
    video.save_npz(npz)
    npz_bytes = os.path.getsize(npz)
    pixels = video.num_frames * video.height * video.width
    print(f"[{label}] .vcs {vcs_bytes} bytes against .npz {npz_bytes} bytes "
          f"({vcs_bytes / npz_bytes:.4f} of it), "
          f"{8 * vcs_bytes / pixels:.4f} bits per pixel; save_vcs median "
          f"{float(np.median(t_save)):.4f} s of "
          f"{[round(t, 4) for t in t_save]}, load_vcs median "
          f"{float(np.median(t_load)):.4f} s of "
          f"{[round(t, 4) for t in t_load]}; K6 launches per load {k6[0]} "
          f"({len(video.gops)} GOPs); native coder ({card})")
    return loaded


def run_codec(frames, backend: str, cfg, container=None, report=None):
    """Encode -> decode through the user entry points, the stream crossing
    a container (`container`: "vcs" through `cross_vcs`, which reports and
    checks the container when given `report` = (label, card), or "npz";
    checked field for field) or, for timing runs (None), a copy in host
    memory; then, with lossy intra, the intra decode of the stream's I-frame
    payloads in batches of 8 GOPs (as the JAX package's bench charges it).
    Returns (decoded frames, encoded video, per GOP the tuple of
    intra-decoded I planes, encode s, decode s, intra decode s)."""
    import dataclasses
    import torch
    from vcs_h264_tpu_torch.models import Decoder, EncodedVideo, Encoder
    from vcs_h264_tpu_torch.models import intra_codec, pipeline420
    from vcs_h264_tpu_torch.models.gop import EncodedGOP420

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    video = Encoder(cfg, device="cuda", backend=backend).encode_frames(frames)
    torch.cuda.synchronize()
    t_enc = time.perf_counter() - t0
    if container:
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, f"stream.{container}")
            if container == "vcs":
                loaded = cross_vcs(video, path, backend, report)
            else:
                video.save_npz(path)
                loaded = EncodedVideo.load_npz(path)
        same_fields(video, loaded, f".{container} roundtrip")
    else:
        loaded = dataclasses.replace(
            video, gops=[g.to("cpu") for g in video.gops])
    t0 = time.perf_counter()
    decoded = Decoder(device="cuda", backend=backend).decode(loaded)
    t_dec = time.perf_counter() - t0
    i_dec, t_intra = [], 0.0
    if cfg.intra_qstep:
        t0 = time.perf_counter()
        for s in range(0, len(loaded.gops), GOPS):
            chunk = loaded.gops[s:s + GOPS]
            if cfg.chroma_420:
                # the payloads and I planes alone: a tail GOP then stacks
                batch = EncodedGOP420.stack([EncodedGOP420(
                    g.i_y, g.i_c, g.mv[:0], None, None,
                    *(getattr(g, k) for k in g.PAYLOAD)) for g in chunk],
                    "cuda")
                out = pipeline420.decode_intra_420(batch, cfg.intra_qstep,
                                                   backend)
                i_dec.extend(zip(out.i_y.cpu(), out.i_c.cpu()))
                continue
            pay = intra_codec.IntraFrameLossy(*(
                torch.stack([getattr(g, k) for g in chunk]).cuda()
                for k in PAYLOAD))
            i_dec.extend((x,) for x in
                         intra_codec.decode_intra_frames_lossy_batch(
                             pay, cfg.intra_qstep, backend).cpu())
        t_intra = time.perf_counter() - t0
    return decoded, video, i_dec, t_enc, t_dec, t_intra


def psnr_of(decoded, frames, idx) -> float:
    from vcs_h264_tpu_torch.utils.metrics import psnr
    return float(np.mean([psnr(decoded[i], frames[i]) for i in idx]))


def frame_kinds(cfg, n: int) -> dict:
    """Display index -> "I", "P" or "B": full GOPs follow the pattern, a
    tail GOP is coded all-P."""
    kinds = {}
    for i in range(n):
        g, pos = divmod(i, cfg.gop_len)
        full = (g + 1) * cfg.gop_len <= n
        kinds[i] = "I" if pos == 0 else (
            cfg.gop_pattern[pos] if full else "P")
    return kinds


def stream_diff(video, video_plain):
    """(vectors identical, residual values that differ, their count, the
    largest difference) between the kernel and the plain path's streams."""
    import torch
    same_mv, n_diff, n_all, worst = True, 0, 0, 0.0
    for a, b in zip(video.gops, video_plain.gops):
        for k in ("mv", "b_mv", "b_mode"):
            x, y = getattr(a, k), getattr(b, k)
            same_mv &= (x is None) == (y is None) and (
                x is None or torch.equal(x.cpu(), y.cpu()))
        for k in ("residuals", "b_residuals", "res_y", "res_c", "bres_y",
                  "bres_c"):
            x, y = getattr(a, k, None), getattr(b, k, None)
            if x is None or y is None:
                continue
            d = (x.cpu().double() - y.cpu().double()).abs()
            n_diff += int((d != 0).sum())
            n_all += d.numel()
            worst = max(worst, float(d.max()))
    return same_mv, n_diff, n_all, worst


def main_path_phase(frames, card: str, cfg, label: str, want, forbid=(),
                    runs: int = 3, exact: bool = False,
                    tf32_check: bool = False, psnr_floor: float = 30.0,
                    plain_once: bool = False):
    """Phase 5: the port's user entry points, kernels vs plain versions.
    `want` kernels must launch in the counted run, `forbid` ones must not;
    `exact`: the decoded frames must be identical to the plain path's;
    `tf32_check`: an encode with TF32 allowed must give identical
    residuals; `psnr_floor`: the least plausible P/B-frame PSNR;
    `plain_once`: the plain path, seconds long where it runs the plain
    wavefront, is run for the comparison only and timed by that one run.
    Returns the counted run's launch counts."""
    import torch

    run_codec(frames, "auto", cfg)     # warm-up
    if runs > 1 and not plain_once:
        run_codec(frames, "plain", cfg)
    reset_counts()
    decoded, video, i_dec, *t_k = run_codec(
        frames, "auto", cfg, container_of(cfg), report=(label, card))
    launches = read_counts()
    print(f"[{label}] kernel launches {launches}")
    if container_of(cfg) == "vcs":
        from vcs_h264_tpu_torch.models import Decoder
        if any(not np.array_equal(a, b) for a, b in
               zip(decoded, Decoder(device="cuda").decode(video))):
            fail(f"frames decoded from the loaded .vcs differ from the "
                 f"in-memory stream's ({label})")
        print(f"[{label}] the frames decoded from the loaded .vcs are "
              "identical to the in-memory stream's")
    if any(launches[k] == 0 for k in want):
        fail(f"a kernel of the main path was never launched ({label})")
    if any(launches[k] != 0 for k in forbid):
        fail(f"{label} launched {[k for k in forbid if launches[k]]}, "
             "which it must not take")
    dec_plain, video_plain, i_dec_plain, *t_p = run_codec(
        frames, "plain", cfg, container_of(cfg))
    times = {"auto": [t_k], "plain": [t_p]}
    if runs == 3:       # two more runs of each path, interleaved
        for backend in (("auto", "auto") if plain_once
                        else ("plain", "auto", "auto", "plain")):
            times[backend].append(run_codec(frames, backend, cfg)[3:])

    if len(decoded) != len(frames) or decoded[0].shape != (H, W, 3):
        fail(f"decoded {len(decoded)} frames of {decoded[0].shape}")
    kinds = frame_kinds(cfg, len(frames))
    psnr = {}
    for kind in sorted(set(kinds.values())):
        idx = [i for i, k in kinds.items() if k == kind]
        psnr[kind] = {b: psnr_of(d, frames, idx) for b, d in
                      (("kernels", decoded), ("plain", dec_plain))}
    mvs = np.concatenate([g.mv.cpu().numpy().reshape(-1, 2)
                          for g in video.gops])
    static = float(np.mean(np.all(mvs == 0, axis=-1)))
    same_mv, n_co, n_all, max_co = stream_diff(video, video_plain)
    pix_diff = max(int(np.abs(a.astype(np.int32) - b).max())
                   for a, b in zip(decoded, dec_plain))
    print(f"[{label}] {len(frames)} frames {W}x{H}, {len(video.gops)} GOPs; "
          + "; ".join(f"{k}-frame PSNR kernels {v['kernels']:.4f} dB, plain "
                      f"{v['plain']:.4f} dB" for k, v in psnr.items())
          + f"; static-block ratio {static:.4f}; vectors and modes identical"
          f" to plain {same_mv}; residual values that differ from plain "
          f"{n_co} of {n_all} (max |diff| {max_co:g}); max decoded pixel "
          f"diff {pix_diff}")
    if not same_mv:
        fail(f"vectors or B modes differ from the plain path ({label})")
    if exact and pix_diff:
        fail(f"decoded frames differ from the plain path's ({label})")
    if tf32_check:
        from vcs_h264_tpu_torch.models import Encoder
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            v32 = Encoder(cfg, device="cuda").encode_frames(frames)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        for g, (a, b) in enumerate(zip(video.gops, v32.gops)):
            if not torch.equal(a.residuals, b.residuals):
                fail(f"GOP {g}: coefficients change with TF32 allowed")
        print(f"[{label}] an encode with TF32 allowed gives identical "
              f"coefficients in all {len(video.gops)} GOPs")
    if cfg.intra_qstep:
        i_fields = ("i_y", "i_c") if cfg.chroma_420 else ("i_frame",)
        for g, (a, b) in enumerate(zip(video.gops, video_plain.gops)):
            for k in (*i_fields, *a.PAYLOAD):
                if not torch.equal(getattr(a, k).cpu(), getattr(b, k).cpu()):
                    fail(f"GOP {g}: {k} of the kernel path differs from the "
                         "plain path's")
        for g, (gop, a, b) in enumerate(zip(video.gops, i_dec, i_dec_plain)):
            stored = tuple(getattr(gop, k).cpu() for k in i_fields)
            if not all(torch.equal(x, y) and torch.equal(x, z)
                       for x, y, z in zip(a, stored, b)):
                fail(f"GOP {g}: the intra decode of the loaded payload "
                     "differs from the stored I-frame")
        print(f"[{label}] I-frame reconstructions, modes, escapes and qcoef "
              f"identical to the plain path for all {len(video.gops)} GOPs; "
              "the intra decode of every loaded payload is identical to its "
              "stored I-frame")
    for backend, name in (("auto", "kernels"), ("plain", "plain")):
        runs_t = times[backend]
        fps = [len(frames) / (e + d) for e, d, _ in runs_t]
        line = (f"[{label}] {name}: encode+decode fps median "
                f"{float(np.median(fps)):.2f} of runs "
                f"{[round(x, 2) for x in fps]}; encode s "
                f"{[round(e, 4) for e, _, _ in runs_t]}, decode s "
                f"{[round(d, 4) for _, d, _ in runs_t]}")
        if cfg.intra_qstep:
            fps_i = [len(frames) / (e + d + i) for e, d, i in runs_t]
            line += (f"; with the intra decode: fps median "
                     f"{float(np.median(fps_i)):.2f} of runs "
                     f"{[round(x, 2) for x in fps_i]}, intra decode s "
                     f"{[round(i, 4) for _, _, i in runs_t]}")
        print(f"{line} ({card})")
    for kind, v in psnr.items():
        if kind != "I" and (not np.isfinite(v["kernels"])
                            or v["kernels"] < psnr_floor):
            fail(f"{kind}-frame PSNR {v['kernels']} dB is implausible "
                 f"({label})")
        if abs(v["kernels"] - v["plain"]) > PSNR_TOL_DB:
            fail(f"{kind}-frame PSNR of the kernels {v['kernels']} vs plain "
                 f"{v['plain']} dB differ by more than {PSNR_TOL_DB} "
                 f"({label})")
    return launches


def main_paths() -> list:
    """Phase 5's paths: (config, label, what `main_path_phase` holds it
    to)."""
    from vcs_h264_tpu_torch import CodecConfig

    p_kernels = ("sad_search", "fused_p_encode", "fused_p_decode")
    intra = ("intra_encode", "intra_decode")
    planes = ("sad_search", "plane_encode", "plane_decode", "c420_encode",
              "c420_decode")
    fullres = ("fused_p_encode", "fused_p_decode")
    # PSNR floors: a lossy I-frame lowers the P- and B-frames; reference
    # mode's wrap residual passes cv2's clipped YCrCb, which loses
    # mixed-sign residuals of noisy content by up to 255 at a pixel
    return [
        (CodecConfig.production(), "main path, raw I-frames",
         dict(want=p_kernels)),
        (CodecConfig.production(intra_qstep=QSTEP),
         f"main path, intra_qstep {QSTEP}",
         dict(want=p_kernels + intra, psnr_floor=20.0, plain_once=True)),
        (CodecConfig(), "reference mode",
         dict(want=("sad_search", "compensate"),
              forbid=("fused_p_encode", "fused_p_decode"), exact=True,
              tf32_check=True, psnr_floor=20.0)),
        (CodecConfig.production(intra_qstep=QSTEP, gop_pattern=IBPBPBP),
         f"production B, intra_qstep {QSTEP}",
         dict(want=("compensate",) + p_kernels + intra, runs=1,
              psnr_floor=20.0)),
        (CodecConfig.production(chroma_420=True, intra_qstep=QSTEP),
         f"4:2:0, intra_qstep {QSTEP}",
         dict(want=planes + intra, forbid=fullres, runs=1, exact=True,
              psnr_floor=20.0)),
        (CodecConfig.production(chroma_420=True, intra_qstep=QSTEP,
                                gop_pattern=IBPBPBP),
         f"4:2:0 B, intra_qstep {QSTEP}",
         dict(want=("compensate",) + planes + intra, forbid=fullres, runs=1,
              exact=True, psnr_floor=20.0)),
        (CodecConfig.production(intra_qstep=QSTEP, search_luma_only=True),
         f"luma-only search, intra_qstep {QSTEP}",
         dict(want=p_kernels + intra,
              forbid=planes[1:] + ("compensate",), runs=1, psnr_floor=20.0)),
    ]


def profile_path(frames, card: str, cfg, label: str, rows: int = 10) -> None:
    """--profile: one kernel-path run under torch.profiler, after a warm-up
    run: where the device time of the window goes, by kernel or copy."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    run_codec(frames, "auto", cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run_codec(frames, "auto", cfg)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    # device-side rows only: a host-side operator row repeats the device
    # time of the kernels and copies it started
    events = [(e.key, e.self_device_time_total / 1e3, e.count)
              for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.self_device_time_total > 0]
    if not events:
        fail(f"torch.profiler recorded no device time ({label})")
    events.sort(key=lambda r: -r[1])
    total = sum(ms for _, ms, _ in events)
    print(f"[profile {label}] {wall * 1e3:.1f} ms on the host clock (under "
          f"the profiler), {total:.1f} ms of device time in {len(events)} "
          f"rows ({card}):")
    for key, ms, count in events[:rows]:
        print(f"[profile {label}]   {ms:9.3f} ms  x{count:<4d} {key[:90]}")
    copies = [(key, ms, count) for key, ms, count in events
              if key.startswith("Memcpy")]
    for key, ms, count in copies:
        print(f"[profile {label}] copy {ms:9.3f} ms  x{count:<4d} {key}")
    print(f"[profile {label}] memcpy device time "
          f"{sum(ms for _, ms, _ in copies):.1f} ms ({card})")


STREAM_GOP_BATCH = 2          # encode_stream's chunks: 8, 8, 8, 8, 2 frames
STREAM_DROPPED = (1, 5, 8)    # checkpoints deleted before the resume
SURVEYED = 17                 # frames of the other paths' sync census


def blocking_decode(video, gop_batch: int = 8, device: str = "cuda") -> list:
    """The decode as the port ran it before its host path: each batch
    stacked in host memory and copied up from pageable memory, its frames
    brought down by a blocking `.cpu()` (full resolution)."""
    from vcs_h264_tpu_torch.models import pipeline
    cfg = video.config
    out, buf = [], []

    def down(planar):
        out.extend(planar.movedim(-3, -1).contiguous().cpu().numpy())

    def flush():
        if buf:
            down(pipeline.decode_gop_batch(type(buf[0]).stack(buf, device),
                                           cfg).flatten(0, 1))
            buf.clear()

    for gop in video.gops:
        gop = gop.without_intra_payload()
        if gop.num_coded == cfg.gop_len and gop.num_p:
            buf.append(gop)
            if len(buf) >= gop_batch:
                flush()
            continue
        flush()
        if gop.num_p == 0:
            down(gop.i_frame[None])
        else:
            down(pipeline.decode_gop_batch(type(gop).stack([gop], device),
                                           cfg)[0])
    flush()
    return out[:video.num_frames]


def watch_syncs(fn):
    """Run fn under `torch.cuda.set_sync_debug_mode("warn")` -> (its
    result, seconds, the synchronizing CUDA calls it made as (place,
    count))."""
    import warnings
    import torch
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            t0 = time.perf_counter()
            out = fn()
            dt = time.perf_counter() - t0
        finally:
            torch.cuda.set_sync_debug_mode(0)
    seen = {}
    for w in caught:
        if "called a synchronizing CUDA operation" in str(w.message):
            place = f"{os.path.relpath(w.filename)}:{w.lineno}"
            seen[place] = seen.get(place, 0) + 1
    return out, dt, sorted(seen.items())


def checkpoint_fingerprints(ckpt: str) -> list:
    out = []
    for name in sorted(os.listdir(ckpt)):
        with np.load(os.path.join(ckpt, name)) as z:
            out.append(str(z["cfg"][0]))
    return out


def stream_phase(frames, card: str) -> dict:
    """Phase 6, the streaming path on the main path's configuration
    (production, intra_qstep 24) with gop_batch 2, so that `encode_stream`
    takes five chunks of 8, 8, 8, 8 and 2 frames. Its counted run is the
    overlapped window, `encode_stream` over an in-memory reader and
    `Decoder.iter_frames` over the stream's copy in host memory, each under
    `torch.cuda.set_sync_debug_mode("warn")`: it prints every host sync
    there, and those of the blocking decode as a control (which must show
    some); then the same census for each of the other paths of phase 5.
    Then: the stream equals `encode_frames`'s field for field and
    its .vcs has the same bytes; the frames of `iter_frames` are identical
    to `decode()`'s and to the decode as it ran before the host path
    (`blocking_decode`), from host and from device memory; a checkpointed
    encode under `Encoder(metrics=..., profile=True)` logs 9 gop records,
    an encode_summary and the stage timings that apply; with three GOP
    files deleted a second encode launches K2, K3 and K5 only for the
    missing GOPs and returns the same stream, which decodes to the same
    frames; with intra_qstep changed, all nine are encoded again;
    `device_trace` leaves a non-empty trace file. Returns the counted run's
    launches."""
    import dataclasses
    import torch
    from vcs_h264_tpu_torch import CodecConfig
    from vcs_h264_tpu_torch.io import bitstream
    from vcs_h264_tpu_torch.models import Decoder, Encoder
    from vcs_h264_tpu_torch.tools.clips import ClipReader
    from vcs_h264_tpu_torch.utils.metrics import MetricsLogger
    from vcs_h264_tpu_torch.utils.profiling import device_trace

    label = "stream"
    t_phase = time.perf_counter()
    cfg = CodecConfig.production(intra_qstep=QSTEP)
    video = Encoder(cfg, device="cuda").encode_frames(frames)
    host = dataclasses.replace(video, gops=[g.to("cpu") for g in video.gops])
    Encoder(cfg, STREAM_GOP_BATCH, device="cuda").encode_stream(
        ClipReader(frames[:8]))                                 # warm-up
    torch.cuda.synchronize()

    reset_counts()
    streamed, t_enc, sync_enc = watch_syncs(
        lambda: Encoder(cfg, STREAM_GOP_BATCH, device="cuda").encode_stream(
            ClipReader(frames)))
    iterated, t_dec, sync_dec = watch_syncs(
        lambda: list(Decoder(device="cuda").iter_frames(host)))
    launches = read_counts()
    torch.cuda.synchronize()
    blocked, t_blk, sync_blk = watch_syncs(lambda: blocking_decode(host))
    for what, dt, syncs in (
            ("encode_stream (5 chunks, queued)", t_enc, sync_enc),
            ("iter_frames from host memory", t_dec, sync_dec),
            ("control, outside the window: the blocking decode from host "
             "memory", t_blk, sync_blk)):
        print(f"[{label}] {what}: {dt:.4f} s, host syncs "
              f"{sum(n for _, n in syncs)} at {len(syncs)} places "
              f"{syncs} ({card})")
    print(f"[{label}] the window's kernel launches {launches}")
    resident = sum(nbytes(t) for g in streamed.gops for t in g._fields()
                   if t is not None)
    per_frame = resident / streamed.num_frames
    total = torch.cuda.get_device_properties(0).total_memory
    print(f"[{label}] the encoded stream stays on the device: {resident} "
          f"bytes, {per_frame:.0f} a frame; {total} bytes of device memory "
          f"hold {total / per_frame / 30 / 60:.2f} minutes of this video at "
          f"30 fps")
    if not sync_blk:
        fail("the sync debug mode saw no sync in the blocking decode")
    for cfg_p, label_p, _ in main_paths():     # the other paths' syncs
        if cfg_p == cfg:
            continue
        enc = Encoder(cfg_p, STREAM_GOP_BATCH, device="cuda")
        dec = Decoder(device="cuda")
        clip = ClipReader(frames[:SURVEYED])
        enc.encode_stream(clip)                                 # warm-up
        v, _, s_enc = watch_syncs(lambda: enc.encode_stream(clip))
        on_host = dataclasses.replace(v, gops=[g.to("cpu") for g in v.gops])
        list(dec.iter_frames(on_host))                          # warm-up
        _, _, s_dec = watch_syncs(lambda: list(dec.iter_frames(on_host)))
        print(f"[{label} census: {label_p}] encode_stream of {SURVEYED} "
              f"frames, host syncs {sum(n for _, n in s_enc)} at {s_enc}; "
              f"iter_frames from host memory, host syncs "
              f"{sum(n for _, n in s_dec)} at {s_dec}")
    if any(launches[k] == 0 for k in ("sad_search", "fused_p_encode",
                                      "fused_p_decode", "intra_encode")):
        fail(f"a kernel of the streaming path was never launched "
             f"({launches})")

    same_fields(video, streamed, "encode_stream against encode_frames")
    with tempfile.TemporaryDirectory() as tmp:
        paths = [os.path.join(tmp, f"{n}.vcs") for n in ("frames", "stream")]
        bitstream.save_vcs(video, paths[0])
        bitstream.save_vcs(streamed, paths[1])
        blobs = [open(p, "rb").read() for p in paths]
        if blobs[0] != blobs[1]:
            fail("the streamed .vcs differs from the in-memory stream's")
        same_fields(video, bitstream.load_vcs(paths[1]), "the streamed .vcs")
    print(f"[{label}] encode_stream (gop_batch {STREAM_GOP_BATCH}) equals "
          f"encode_frames field for field in {len(streamed.gops)} GOPs; "
          f"both .vcs files {len(blobs[1])} bytes, identical")

    decoded = Decoder(device="cuda").decode(video)
    for what, got in (
            ("iter_frames from host memory", iterated),
            ("iter_frames from device memory",
             list(Decoder(device="cuda").iter_frames(streamed))),
            ("the blocking decode from host memory", blocked),
            ("the blocking decode from device memory",
             blocking_decode(video))):
        if len(got) != len(frames) or any(
                not np.array_equal(a, b) for a, b in zip(got, decoded)):
            fail(f"{what} differs from decode()")
    print(f"[{label}] iter_frames from host and from device memory, and the "
          f"blocking decode of both: {len(decoded)} frames identical to "
          "decode()")

    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "ckpt")
        log_path = os.path.join(tmp, "metrics.jsonl")
        logger = MetricsLogger(log_path)
        first = Encoder(cfg, STREAM_GOP_BATCH, logger, True,
                        device="cuda").encode_frames(
                            frames, checkpoint_dir=ckpt)
        logger.close()
        same_fields(video, first, "the checkpointed, profiled encode")
        names = sorted(os.listdir(ckpt))
        if names != [f"gop_{g:06d}.npz" for g in range(len(video.gops))]:
            fail(f"checkpoint files {names}")
        for g in STREAM_DROPPED:
            os.remove(os.path.join(ckpt, names[g]))
        full = [g for g in STREAM_DROPPED if g < GOPS]
        want = -(-len(full) // STREAM_GOP_BATCH) + len(STREAM_DROPPED) \
            - len(full)
        reset_counts()
        resumed = Encoder(cfg, STREAM_GOP_BATCH, device="cuda").encode_frames(
            frames, checkpoint_dir=ckpt)
        got = read_counts()
        expect = {k: (want if k in ("sad_search", "fused_p_encode",
                                    "intra_encode") else 0) for k in got}
        if got != expect:
            fail(f"the resume launched {got}, not {expect}")
        same_fields(video, resumed, "the resumed encode")
        where = sorted({g.i_frame.device.type for g in resumed.gops})
        if any(not np.array_equal(a, b) for a, b in
               zip(Decoder(device="cuda").decode(resumed), decoded)):
            fail("the resumed stream decodes to other frames")
        print(f"[{label}] checkpoints: {len(names)} files; with GOPs "
              f"{list(STREAM_DROPPED)} deleted the resume launched {got} "
              f"and returned the same stream (GOPs in {where} memory), "
              "decoded to the same frames")
        requant = dataclasses.replace(cfg, intra_qstep=QSTEP + 8)
        reset_counts()
        Encoder(requant, STREAM_GOP_BATCH, device="cuda").encode_frames(
            frames, checkpoint_dir=ckpt)
        got = read_counts()
        batches = -(-GOPS // STREAM_GOP_BATCH) + 1
        if any(got[k] != batches for k in ("sad_search", "fused_p_encode",
                                           "intra_encode")):
            fail(f"after intra_qstep changed the encode launched {got}, "
                 f"not {batches} each of K2, K3, K5")
        prints = checkpoint_fingerprints(ckpt)
        if len(prints) != len(names) or any(
                f'"intra_qstep": {QSTEP + 8}' not in p for p in prints):
            fail("stale checkpoints were not rewritten")
        print(f"[{label}] with intra_qstep {QSTEP + 8} all {len(prints)} "
              f"GOPs were encoded again ({got})")

        with open(log_path) as fh:
            records = [json.loads(line) for line in fh]
        events = [r["event"] for r in records]
        timings = [r for r in records if r["event"] == "stage_timings"]
        stages = sorted(set(timings[0]) - {"ts", "event"}) if timings else []
        applies = sorted({"intra_i_encode", "encode_gop_batch",
                          "checkpoint_write"})
        if (events.count("gop") != len(video.gops)
                or events.count("encode_summary") != 1
                or len(timings) != 1 or stages != applies
                or any(list(r)[:2] != ["ts", "event"] for r in records)):
            fail(f"metrics records {events}, stages {stages}")
        summary = records[events.index("encode_summary")]
        print(f"[{label}] metrics: {events.count('gop')} gop records, "
              f"encode_summary {summary['fps']:.2f} fps (profiled, "
              f"checkpointed), stage_timings ms "
              f"{ {k: timings[0][k] for k in stages} }")

        trace_dir = os.path.join(tmp, "trace")
        with device_trace(trace_dir):
            Decoder(device="cuda").decode(video)
        traces = [os.path.join(trace_dir, n) for n in os.listdir(trace_dir)]
        if not traces or not all(os.path.getsize(p) > 0 for p in traces):
            fail(f"device_trace left {traces}")
        print(f"[{label}] device_trace wrote {os.path.basename(traces[0])} "
              f"({os.path.getsize(traces[0])} bytes)")
    print(f"[{label}] phase {time.perf_counter() - t_phase:.1f} s; "
          "VideoReader, VideoWriter, encode_video and decode_to_file need "
          "cv2, which this machine may lack: the CPU tests drive them")
    return launches


LEGACY_VERSIONS = range(3, 11)


def legacy_vcs_phase(card: str) -> None:
    """Phase 4, the legacy containers (tests/fixtures/legacy_v3.vcs ... v10, 48x64,
    10 frames): loaded with the I-frames decoded by K6 on the card
    (lossless for v3/v4, lossy for v5-v10, 4:2:0 for v6/v7), decoded on the
    card, and held to the frames stored beside them within the CPU test's
    bound: +-1 on fewer than 5e-3 of each frame's values."""
    from vcs_h264_tpu_torch.io import bitstream
    from vcs_h264_tpu_torch.models import Decoder

    fixtures = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "tests", "fixtures")
    for version in LEGACY_VERSIONS:
        reset_counts()
        loaded = bitstream.load_vcs(
            os.path.join(fixtures, f"legacy_v{version}.vcs"))
        k6 = read_counts()["intra_decode"]
        if k6 != (2 if loaded.config.chroma_420 else 1):
            fail(f"legacy v{version}: {k6} K6 launches in the load")
        got = Decoder(device="cuda").decode(loaded)
        with np.load(os.path.join(fixtures,
                                  f"legacy_v{version}_frames.npz")) as z:
            want = [z[f"f{i}"] for i in range(len(z.files))]
        if len(got) != len(want):
            fail(f"legacy v{version}: {len(got)} frames, not {len(want)}")
        diffs = [np.abs(a.astype(np.int32) - b) for a, b in zip(got, want)]
        worst = max(int(d.max()) for d in diffs)
        shares = [float(np.mean(d != 0)) for d in diffs]
        print(f"[legacy v{version}] {len(got)} frames, K6 launches {k6}, "
              f"signed_residual {loaded.config.signed_residual}; max |diff| "
              f"{worst}, share of values that differ {np.mean(shares):.6f} "
              f"(worst frame {max(shares):.6f}) ({card})")
        if worst > 1 or max(shares) >= 5e-3:
            fail(f"legacy v{version} decodes outside +-1 on 5e-3 of values")


STUDY_QSTEP = QSTEP


def timed_cuda(fn):
    """(fn's result, host-clock ms of the call, ended by a device sync)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def study_phase(frames, card: str) -> dict:
    """Phase 7, the study functions and single-frame wrappers on one
    1280x720 frame of the clip (and the three after it for the batched
    search), each on the card and on the CPU, where it runs the plain
    versions: the open-loop intra studies (plain PyTorch on both) and the
    wrappers over K5, K6, K2 and K1 give identical integers, the 4:2:0 round
    trip is identical or +-1 on fewer than 1e-4 of samples, the blockwise DCT
    of the luma plane less 128 within 1e-3. Prints each function's
    host-clock ms on the card. Returns the phase's launches."""
    import torch
    from vcs_h264_tpu_torch.ops import color

    label = "study"
    t_phase = time.perf_counter()
    bgr = [torch.from_numpy(f).permute(2, 0, 1).to(torch.int32)
           for f in frames[:4]]
    y, cr, cb = color.bgr_to_ycrcb_planes(bgr[0])
    rows = []

    def check(name, fn, cpu_args, compare="equal"):
        """fn on the card (the arguments moved there) against fn on the
        CPU: identical, or within the named contract. In the warm-up pass
        (`warm`) fn runs once on the card and nothing is checked."""
        dev_args = [a.cuda() if torch.is_tensor(a) else a for a in cpu_args]
        if warm:
            out = fn(*dev_args)
            return out if isinstance(out, tuple) else (out,)
        got, ms = timed_cuda(lambda: fn(*dev_args))
        want = fn(*cpu_args)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        detail = "identical"
        for a, b in zip(got, want):
            a = a.cpu()
            if compare == "equal":
                if a.dtype != b.dtype or not torch.equal(a, b):
                    fail(f"{name} on the card differs from the CPU's")
            elif compare == "420":
                d = (a - b).abs()
                share = float((d != 0).double().mean())
                detail = f"max |diff| {int(d.max())}, share {share:.2e}"
                if int(d.max()) > 1 or share >= 1e-4:
                    fail(f"{name}: {detail} outside +-1 on 1e-4")
            else:
                err = float((a - b).abs().max())
                detail = f"max |diff| {err:.2e}"
                if err > 1e-3:
                    fail(f"{name}: {detail} above 1e-3")
        rows.append((name, ms, detail))
        return got

    for warm in (True, False):        # a warm-up pass, then the checks
        if not warm:
            torch.cuda.synchronize()
            reset_counts()
        study_calls(check, bgr, y, cr, cb)
    launches = read_counts()
    for name, ms, detail in rows:
        print(f"[{label}] {name}: {ms:.3f} ms on the card (host clock), "
              f"against the CPU's plain version {detail} ({card})")
    for k in ("sad_search", "compensate", "intra_encode", "intra_decode"):
        if launches[k] == 0:
            fail(f"the study functions never launched {k}")
    print(f"[{label}] kernel launches {launches}; phase "
          f"{time.perf_counter() - t_phase:.1f} s")
    return launches


def study_calls(check, bgr, y, cr, cb) -> None:
    """The calls of `study_phase`, each through `check(name, fn, CPU
    arguments, contract)`."""
    import torch
    from vcs_h264_tpu_torch.ops import dct, intra, motion, subsample

    check("luma4x4", intra.luma4x4, [y])
    check("luma16x16", intra.luma16x16, [y])
    check("chroma8x8", intra.chroma8x8, [cr, cb])
    q, modes, esc, recon = check(
        "intra_encode4x4_lossy (K5)",
        lambda p: intra.intra_encode4x4_lossy(p, STUDY_QSTEP), [y])
    dec = check("intra_decode4x4_lossy (K6)",
                lambda *a: intra.intra_decode4x4_lossy(*a, STUDY_QSTEP),
                [q.cpu(), modes.cpu(), esc.cpu()])
    if not torch.equal(dec[0], recon):
        fail("intra_decode4x4_lossy differs from the encoder's recon")
    res, lmodes, lesc = intra.luma4x4_codec(y.cuda())
    back = check("intra_decode4x4 (K6, unclipped)", intra.intra_decode4x4,
                 [res.cpu(), lmodes.cpu(), lesc.cpu()])
    if not torch.equal(back[0].cpu(), y):
        fail("intra_decode4x4 of luma4x4_codec did not give the plane back")
    mv = check("motion_search (K2)", motion.motion_search, [bgr[1], bgr[0]])
    check("motion_search_batch (K2)", motion.motion_search_batch,
          [torch.stack(bgr[1:4]), bgr[0]])
    comp = check("motion_compensate (K1)",
                 lambda m, r: motion.motion_compensate(m, r, 8),
                 [mv[0].cpu(), bgr[0]])
    if comp[0].dtype != torch.int32:
        fail(f"motion_compensate returned {comp[0].dtype} for int32 frames")
    check("chroma_420_roundtrip", subsample.chroma_420_roundtrip, [bgr[0]],
          compare="420")
    check("dct2_plane", lambda p: dct.dct2_plane(p - 128, 8), [y],
          compare="float")


class FrameSink:
    """The decode core's sink in memory: keeps the frames written."""

    def __init__(self):
        self.frames = []

    def write(self, frame):
        self.frames.append(frame)

    def close(self):
        pass


MAIN_VCS_BYTES = 4_695_189    # the main path's .vcs at seed 0 (stream_phase)


def direct_encode_vcs(frames, cfg, path: str):
    """Encoder -> save_vcs on the card -> (stream, encode s, the file's
    bytes)."""
    from vcs_h264_tpu_torch.io import bitstream
    from vcs_h264_tpu_torch.models import Encoder
    video, ms = timed_cuda(
        lambda: Encoder(cfg, device="cuda").encode_frames(frames))
    bitstream.save_vcs(video, path)
    with open(path, "rb") as fh:
        return video, ms / 1e3, fh.read()


def cli_phase(frames, card: str, seed: int) -> tuple:
    """Phase 8, the CLI's cores on the card with no cv2, on the clip: the
    encode core of the main path (production, intra_qstep 24) into .vcs,
    whose bytes must equal Encoder -> save_vcs's (4 695 189 at seed 0), then
    the decode core of that file, whose frames must equal Decoder.decode's
    of the direct file (both decode from host memory; core and direct calls
    interleaved, core, direct, direct, core, with their fps); the roundtrip core with profile and metrics into a JSONL
    (9 gop records, an encode_summary, stage_timings, a frame record per
    frame, a summary); the encode core under --chroma-420 (K7 and the
    bare-plane pair), bytes equal to the direct encode's. Returns (the
    phase's launches, the main path's .vcs bytes, the direct encode and
    save seconds)."""
    import contextlib
    import io
    from vcs_h264_tpu_torch import CodecConfig, cli
    from vcs_h264_tpu_torch.io import bitstream
    from vcs_h264_tpu_torch.models import Decoder
    from vcs_h264_tpu_torch.tools.clips import ClipReader

    label = "cli"
    t_phase = time.perf_counter()
    cfg = CodecConfig.production(intra_qstep=QSTEP)
    with tempfile.TemporaryDirectory() as tmp, \
            contextlib.redirect_stdout(io.StringIO()):          # warm-up
        path = os.path.join(tmp, "warm.vcs")
        cli.encode_reader(ClipReader(frames), cfg, path, device="cuda")
        cli.decode_video(cli.load_stream(path, "cuda"), FrameSink(), "memory",
                         device="cuda")
    reset_counts()
    with tempfile.TemporaryDirectory() as tmp:
        core_path = os.path.join(tmp, "core.vcs")
        direct_path = os.path.join(tmp, "direct.vcs")
        times = {"core": [], "direct": []}
        printed = io.StringIO()
        for who in ("core", "direct", "direct", "core"):
            if who == "core":
                with contextlib.redirect_stdout(printed):
                    _, _, t_enc = cli.encode_reader(
                        ClipReader(frames), cfg, core_path, device="cuda")
                    sink = FrameSink()
                    t_dec = cli.decode_video(
                        cli.load_stream(core_path, "cuda"), sink, "memory",
                        device="cuda")
                core_frames = sink.frames
            else:
                t0 = time.perf_counter()
                _, t_enc, blob = direct_encode_vcs(frames, cfg, direct_path)
                t_save = time.perf_counter() - t0 - t_enc
                loaded = bitstream.load_vcs(direct_path)
                t0 = time.perf_counter()
                direct_frames = Decoder(device="cuda").decode(loaded)
                t_dec = time.perf_counter() - t0
            times[who].append((t_enc, t_dec))
        with open(core_path, "rb") as fh:
            core_blob = fh.read()
        if core_blob != blob:
            fail("the encode core's .vcs differs from Encoder -> save_vcs")
        if seed == 0 and len(blob) != MAIN_VCS_BYTES:
            fail(f"the main path's .vcs is {len(blob)} bytes, not "
                 f"{MAIN_VCS_BYTES}")
        if len(core_frames) != len(frames) or any(
                not np.array_equal(a, b)
                for a, b in zip(core_frames, direct_frames)):
            fail("the decode core's frames differ from Decoder.decode's")
        lines = [line for line in printed.getvalue().splitlines()
                 if line.startswith(("encoded ", "decoded "))]
        print(f"[{label}] the cores printed {lines[:2]}")
        print(f"[{label}] encode core .vcs {len(core_blob)} bytes, identical "
              f"to Encoder -> save_vcs; the decode core's {len(core_frames)} "
              "frames identical to Decoder.decode's")
        for who, runs in times.items():
            print(f"[{label}] {who}: encode fps "
                  f"{[round(len(frames) / e, 2) for e, _ in runs]}, decode "
                  f"fps {[round(len(frames) / d, 2) for _, d in runs]} "
                  f"({card})")

        metrics = os.path.join(tmp, "metrics.jsonl")
        with contextlib.redirect_stdout(printed):
            _, recon, mean_psnr = cli.roundtrip_frames(
                frames, 25.0, cfg, profile=True, metrics=metrics,
                device="cuda")
        with open(metrics) as fh:
            events = [json.loads(line)["event"] for line in fh]
        want = {"gop": -(-len(frames) // cfg.gop_len), "encode_summary": 1,
                "stage_timings": 1, "frame": len(frames), "summary": 1}
        if {e: events.count(e) for e in set(events)} != want \
                or not np.isfinite(mean_psnr) or len(recon) != len(frames):
            fail(f"the roundtrip core logged {events}, mean PSNR "
                 f"{mean_psnr}")
        if "stage timings" not in printed.getvalue():
            fail("the roundtrip core printed no stage timings")
        print(f"[{label}] roundtrip core (profile, metrics): mean PSNR "
              f"{mean_psnr:.4f} dB, records {want}")

        cfg420 = CodecConfig.production(chroma_420=True)
        c0 = read_counts()
        with contextlib.redirect_stdout(printed):
            cli.encode_reader(ClipReader(frames), cfg420, core_path,
                              device="cuda")
        c1 = read_counts()
        _, _, blob420 = direct_encode_vcs(frames, cfg420, direct_path)
        with open(core_path, "rb") as fh:
            if fh.read() != blob420:
                fail("the --chroma-420 encode core's .vcs differs from "
                     "Encoder -> save_vcs")
        used = {k: c1[k] - c0[k] for k in c1}
        if any(used[k] == 0 for k in ("plane_encode", "c420_encode")) \
                or used["fused_p_encode"]:
            fail(f"the --chroma-420 encode core launched {used}")
        print(f"[{label}] --chroma-420 encode core: .vcs {len(blob420)} "
              f"bytes identical to Encoder -> save_vcs; launched {used}")
    launches = read_counts()
    print(f"[{label}] kernel launches {launches}; phase "
          f"{time.perf_counter() - t_phase:.1f} s")
    return launches, blob, times["direct"][0][0] + t_save


DIST_WORLD = 2
DIST_TIMEOUT_S = 180


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def dist_rank_main(args) -> int:
    """One rank of `distributed_phase`: the clip from --seed, this rank's
    span of the main path encoded by `parallel.encode_distributed` into
    --dist-dir/ckpt, and on rank 0 the assembled stream written to
    --dist-dir/dist.vcs. Prints one line: the span; the seconds to import
    torch and reach the card, to meet at the store, to make the clip, to be
    ready; and the seconds and launches of each `Encoder.encode_frames`
    call (the span's, and on rank 0 the assembling pass's)."""
    t0 = time.perf_counter()
    import torch
    from vcs_h264_tpu_torch import CodecConfig
    from vcs_h264_tpu_torch.io import bitstream
    from vcs_h264_tpu_torch.models import encoder as encoder_mod
    from vcs_h264_tpu_torch.parallel import distributed
    from vcs_h264_tpu_torch.tools.clips import synthetic_clip

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.set_num_threads(2)
    t_import = time.perf_counter() - t0
    rank, world = distributed.init_distributed(
        args.dist_coordinator, args.dist_world, args.dist_rank)
    t_store = time.perf_counter() - t0 - t_import
    frames = synthetic_clip(args.seed, CLIP_FRAMES)
    t_clip = time.perf_counter() - t0 - t_import - t_store
    calls = []
    inner = encoder_mod.Encoder.encode_frames

    def counted(self, *a, **k):
        c0, t = read_counts(), time.perf_counter()
        out = inner(self, *a, **k)
        torch.cuda.synchronize()
        c1 = read_counts()
        calls.append({"s": round(time.perf_counter() - t, 4),
                      "launches": {n: c1[n] - c0[n] for n in c1
                                   if c1[n] - c0[n]}})
        return out

    encoder_mod.Encoder.encode_frames = counted
    t_ready = time.perf_counter() - t0
    cfg = CodecConfig.production(intra_qstep=QSTEP)
    video = distributed.encode_distributed(
        frames, 25.0, cfg, checkpoint_dir=os.path.join(args.dist_dir, "ckpt"),
        rank=rank, world=world, device="cuda")
    if video is not None:
        bitstream.save_vcs(video, os.path.join(args.dist_dir, "dist.vcs"))
    span = distributed.assign_gops(-(-CLIP_FRAMES // cfg.gop_len), world,
                                   rank)
    print(f"[dist rank {rank}/{world}] " + json.dumps(dict(
        gops=[span[0], span[-1]], device=torch.cuda.current_device(),
        import_s=round(t_import, 4), store_s=round(t_store, 4),
        clip_s=round(t_clip, 4), ready_s=round(t_ready, 4),
        total_s=round(time.perf_counter() - t0, 4), calls=calls)),
        flush=True)
    torch.distributed.destroy_process_group()
    return 0


def run_ranks(seed: int, dist_dir: str):
    """Two ranks of this script on the one card -> (their return codes,
    outputs, wall seconds)."""
    here = os.path.dirname(os.path.abspath(__file__))
    port = free_port()
    env = {**os.environ, "PYTHONPATH": here, "OMP_NUM_THREADS": "2"}
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(here, "chip_smoke.py"), "--seed",
         str(seed), "--dist-rank", str(r), "--dist-world", str(DIST_WORLD),
         "--dist-coordinator", f"localhost:{port}", "--dist-dir", dist_dir],
        cwd=here, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(DIST_WORLD)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=DIST_TIMEOUT_S)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        fail(f"a rank did not finish within {DIST_TIMEOUT_S} s")
    return [p.returncode for p in procs], outs, time.perf_counter() - t0


def distributed_phase(card: str, seed: int, single_vcs: bytes,
                      single_s: float) -> dict:
    """Phase 9, the GOP axis across processes: two ranks of this script
    (`--dist-rank`) on the one card meet at a store on localhost, each
    encodes its span of the main path into a shared checkpoint directory,
    and rank 0 assembles and writes the .vcs. Fails unless both exit 0
    within the time limit, the bytes equal the one-process .vcs, and rank
    0's assembling pass launched no K2, K3 or K5. Prints each rank's line
    and the wall time beside the one-process encode and save. Returns both
    ranks' launches."""
    label = "distributed"
    with tempfile.TemporaryDirectory() as tmp:
        rcs, outs, wall = run_ranks(seed, tmp)
        if any(rcs) and "address already in use" in "".join(outs).lower():
            shutil.rmtree(tmp)
            os.makedirs(tmp)
            rcs, outs, wall = run_ranks(seed, tmp)    # the port was taken
        for r, out in enumerate(outs):
            for line in out.strip().splitlines()[-12:]:
                print(f"[{label} rank {r}] {line}")
        if rcs != [0] * DIST_WORLD:
            fail(f"the ranks exited with {rcs}")
        with open(os.path.join(tmp, "dist.vcs"), "rb") as fh:
            blob = fh.read()
        n_files = len(os.listdir(os.path.join(tmp, "ckpt")))
    records = []
    for r, out in enumerate(outs):
        tag = f"[dist rank {r}/{DIST_WORLD}] "
        line = [x for x in out.splitlines() if x.startswith(tag)]
        if not line:
            fail(f"rank {r} printed no record")
        records.append(json.loads(line[-1][len(tag):]))
    if blob != single_vcs:
        fail("the two-rank .vcs differs from the one-process .vcs")
    assemble = records[0]["calls"][-1]["launches"]
    if len(records[0]["calls"]) != 2 or any(
            assemble.get(k) for k in ("sad_search", "fused_p_encode",
                                      "intra_encode")):
        fail(f"rank 0's assembling pass launched {assemble}")
    launches = {}
    for rec in records:
        for call in rec["calls"]:
            for k, v in call["launches"].items():
                launches[k] = launches.get(k, 0) + v
    print(f"[{label}] {DIST_WORLD} ranks on one card: .vcs {len(blob)} "
          f"bytes identical to the one-process .vcs, {n_files} checkpoint "
          f"files, rank 0's assembling pass launched {assemble}; wall "
          f"{wall:.2f} s for both ranks (each rank ready, with its start-up, "
          f"the clip and the store, after "
          f"{[r['ready_s'] for r in records]} s; done after "
          f"{[r['total_s'] for r in records]} s) against {single_s:.4f} s "
          f"for the one-process encode and save ({card})")
    return launches


# (label, CodecConfig.production's arguments, (gop, tile) meshes, kernels
# the sharded window must launch)
SPATIAL_CASES = (
    ("production", dict(intra_qstep=QSTEP), ((2, 2), (1, 3)),
     ("sad_search", "fused_p_encode", "fused_p_decode", "intra_encode",
      "intra_decode")),
    ("production B", dict(intra_qstep=QSTEP, gop_pattern=IBPBPBP),
     ((2, 2),), ("sad_search", "fused_p_encode", "fused_p_decode",
                 "compensate", "intra_encode", "intra_decode")),
    ("4:2:0", dict(chroma_420=True, intra_qstep=QSTEP), ((1, 3),),
     ("sad_search", "plane_encode", "plane_decode", "c420_encode",
      "c420_decode", "intra_encode", "intra_decode")),
)
SPATIAL_REPS = 3


def spatial_positions(n: int) -> list:
    """n mesh positions: a card each while there are cards, then again
    from cuda:0."""
    import torch
    count = torch.cuda.device_count()
    return [torch.device("cuda", i % count) for i in range(n)]


def event_ms(fn):
    """(fn's result, ms between CUDA events around the call)."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def unsharded_encode(i_b, p_b, cfg):
    """The Encoder's batch without the Encoder's upload: lossy intra (K5),
    then `pipeline.encode_gop_batch` on its reconstruction, or the 4:2:0
    `encode_gop_batch_420`."""
    import dataclasses
    from vcs_h264_tpu_torch.models import intra_codec, pipeline, pipeline420
    if cfg.chroma_420:
        return pipeline420.encode_gop_batch_420(i_b, p_b, cfg)
    pay, rec = intra_codec.encode_intra_frames_lossy_batch(i_b,
                                                           cfg.intra_qstep)
    return dataclasses.replace(pipeline.encode_gop_batch(rec, p_b, cfg),
                               i_qcoef=pay.qcoef, i_modes=pay.modes,
                               i_escape=pay.escape)


def spatial_phase(frames, card: str) -> dict:
    """Phase 10, the row-tiled (gop x tile) mesh of `parallel/spatial.py`
    on the clip's full GOPs at 1280x720 (mesh positions on distinct cards
    where there are several, else all on cuda:0): the main path on meshes
    2 x 2 (tiles of 360 rows) and 1 x 3 (240), production B on 2 x 2 (K1
    and the exchange of decoded anchors), 4:2:0 on 1 x 3. Each sharded
    window (encode, save_vcs, load_vcs with K6, the sharded decode of the
    loaded stream) is counted and must launch the case's kernels. The
    sharded stream must equal the unsharded one field for field, its .vcs
    the Encoder's bytes, and the sharded decode the unsharded decode.
    Prints each case's sharded and unsharded encode and decode ms (CUDA
    events, medians of SPATIAL_REPS, in turns). Returns the launches of
    the counted windows."""
    import dataclasses
    import torch
    from vcs_h264_tpu_torch import CodecConfig
    from vcs_h264_tpu_torch.io import bitstream
    from vcs_h264_tpu_torch.models import EncodedVideo, Encoder
    from vcs_h264_tpu_torch.models import pipeline, pipeline420
    from vcs_h264_tpu_torch.parallel import mesh as pmesh, spatial

    label = "spatial"
    t_phase = time.perf_counter()
    positions = spatial_positions(4)
    dev = positions[0]
    print(f"[{label}] mesh positions {[str(p) for p in positions]} "
          f"({torch.cuda.device_count()} card(s))")
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        for case, kw, meshes, want in SPATIAL_CASES:
            cfg = CodecConfig.production(**kw)
            n_gops = len(frames) // cfg.gop_len
            n = n_gops * cfg.gop_len
            clip = torch.from_numpy(np.stack(frames[:n])).to(dev)
            clip = clip.permute(0, 3, 1, 2).reshape(n_gops, cfg.gop_len, 3,
                                                    H, W)
            i_b, p_b = clip[:, 0].contiguous(), clip[:, 1:].contiguous()
            if cfg.chroma_420:
                enc_s, dec_s = (spatial.sharded_encode_gop_batch_420,
                                spatial.sharded_decode_gop_batch_420)

                def dec_u(s):
                    return pipeline420.decode_gop_batch_420(s, cfg)
            else:
                enc_s, dec_s = (spatial.sharded_encode_gop_batch,
                                spatial.sharded_decode_gop_batch)

                def dec_u(s):
                    return pipeline.decode_gop_batch(s, cfg)
            want_stream = unsharded_encode(i_b, p_b, cfg)
            want_dec = dec_u(want_stream)
            ref_path = os.path.join(tmp, "ref.vcs")
            bitstream.save_vcs(Encoder(cfg, device=dev).encode_frames(
                frames[:n]), ref_path, device=dev)
            with open(ref_path, "rb") as fh:
                ref_bytes = fh.read()
            for gop, tile in meshes:
                what = f"{case}, mesh {gop} x {tile}"
                mesh = pmesh.make_mesh(gop, tile, positions[:gop * tile])
                dec_s(enc_s(i_b, p_b, cfg, mesh), cfg, mesh)     # warm-up
                torch.cuda.synchronize()
                reset_counts()
                got = enc_s(i_b, p_b, cfg, mesh)
                path = os.path.join(tmp, "sharded.vcs")
                bitstream.save_vcs(EncodedVideo(
                    cfg, H, W, 25.0, n,
                    [got.select(b) for b in range(n_gops)]), path,
                    device=dev)
                loaded = bitstream.load_vcs(path, device=dev)
                dec = dec_s(type(got).stack(loaded.gops, dev), cfg, mesh)
                torch.cuda.synchronize()
                counts = read_counts()
                for k, v in counts.items():
                    launches[k] = launches.get(k, 0) + v
                with open(path, "rb") as fh:
                    if fh.read() != ref_bytes:
                        fail(f"the sharded .vcs differs from the Encoder's "
                             f"({what})")
                for f in dataclasses.fields(got):
                    a = getattr(got, f.name)
                    b = getattr(want_stream, f.name)
                    if (a is None) != (b is None) or (a is not None and (
                            a.dtype != b.dtype or not torch.equal(a, b))):
                        fail(f"sharded {f.name} differs from unsharded "
                             f"({what})")
                if dec.dtype != torch.uint8 or not torch.equal(dec,
                                                               want_dec):
                    fail(f"the sharded decode differs from the unsharded "
                         f"decode ({what})")
                missing = [k for k in want if counts[k] == 0]
                if missing:
                    fail(f"the sharded window never launched {missing} "
                         f"({what})")
                ms = {k: [] for k in ("enc_s", "enc_u", "dec_s", "dec_u")}
                for rep in range(SPATIAL_REPS):
                    order = ("s", "u") if rep % 2 == 0 else ("u", "s")
                    for side in order:
                        if side == "s":
                            s, t_e = event_ms(
                                lambda: enc_s(i_b, p_b, cfg, mesh))
                            _, t_d = event_ms(lambda: dec_s(s, cfg, mesh))
                        else:
                            s, t_e = event_ms(
                                lambda: unsharded_encode(i_b, p_b, cfg))
                            _, t_d = event_ms(lambda: dec_u(s))
                        ms["enc_" + side].append(t_e)
                        ms["dec_" + side].append(t_d)
                med = {k: float(np.median(v)) for k, v in ms.items()}
                print(f"[{label}] {what}, {n_gops} GOPs of {cfg.gop_len} at "
                      f"{W}x{H}: stream, .vcs ({len(ref_bytes)} bytes) and "
                      f"decode identical to unsharded; encode ms sharded "
                      f"{med['enc_s']:.3f} / unsharded {med['enc_u']:.3f}, "
                      f"decode ms sharded {med['dec_s']:.3f} / unsharded "
                      f"{med['dec_u']:.3f} (CUDA events, median of "
                      f"{SPATIAL_REPS}; runs {json.dumps(ms)}) ({card})")
                print(f"[{label}] {what}: kernel launches "
                      f"{ {k: v for k, v in counts.items() if v} }")
    print(f"[{label}] kernel launches {launches}; phase "
          f"{time.perf_counter() - t_phase:.1f} s")
    return launches


TOOLS_SLACK = 1.05      # device_ms may exceed ms by this much: two passes
TOOLS_TIMEOUT_S = 300


def run_tool(module: str, args: list, label: str,
             timeout: float = TOOLS_TIMEOUT_S) -> list:
    """`python -m <module> *args` in a process of its own, its lines
    printed under [label] -> its lines."""
    here = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.run(
        [sys.executable, "-m", module, *args],
        cwd=here, env={**os.environ, "PYTHONPATH": here}, capture_output=True,
        text=True, timeout=timeout)
    for line in proc.stdout.splitlines():
        print(f"[{label}] {line}")
    if proc.returncode:
        fail(f"{module} {' '.join(args)} exited {proc.returncode}: "
             f"{proc.stderr[-2000:]}")
    return proc.stdout.splitlines()


def tools_phase(frames, card: str, seed: int, main_vcs: bytes) -> dict:
    """Phase 11, the measurement tools of `vcs_h264_tpu_torch/tools/` on the
    card: `profile_stages --res 720` and `exp_720_stages --tile 2` and
    `--tile 3` on the synthetic source of `seed`, each in a process of its
    own, as a user runs them. Every stage must have
    ms > 0 and device_ms > 0, device_ms <= TOOLS_SLACK x ms, and launch
    exactly the kernels of its tool's EXPECTED_KERNELS. Then
    `bench_sustained.sustained` on the smoke's clip, main path: its `.vcs`
    must equal `main_vcs` (the bytes `cli_phase` wrote), its decode must
    give every frame, identical to Decoder.decode of the loaded file. Each
    tool's JSON goes on [tools] lines. Returns the launches of the tools'
    timed windows and of bench_sustained."""
    from vcs_h264_tpu_torch import CodecConfig
    from vcs_h264_tpu_torch.io import bitstream
    from vcs_h264_tpu_torch.models import Decoder
    from vcs_h264_tpu_torch.tools import (bench_sustained, clips,
                                          exp_720_stages, profile_stages)

    label = "tools"
    t_phase = time.perf_counter()
    runs = ((profile_stages, ["--res", "720"]),
            (exp_720_stages, ["--tile", "2"]),
            (exp_720_stages, ["--tile", "3"]))
    print(f"[{label}] {card}")
    launches = {k: 0 for k in read_counts()}
    for tool, args in runs:
        t0 = time.perf_counter()
        out = json.loads(run_tool(tool.__name__, args + [
            "--synthetic", str(seed), "--device", "cuda"], label)[-1])
        what = f"{out['tool']} at {out['res']}"
        if list(out["stages"]) != list(tool.EXPECTED_KERNELS):
            fail(f"{what}: stages {list(out['stages'])}")
        for name, r in out["stages"].items():
            if not (r["ms"] > 0 and r["device_ms"] > 0):
                fail(f"{what}, {name}: ms {r['ms']}, device_ms "
                     f"{r['device_ms']}")
            if r["device_ms"] > TOOLS_SLACK * r["ms"]:
                fail(f"{what}, {name}: device_ms {r['device_ms']:.4f} above "
                     f"{TOOLS_SLACK} x ms {r['ms']:.4f}")
            if set(r["launches"]) != tool.EXPECTED_KERNELS[name]:
                fail(f"{what}, {name}: launched {r['launches']}, expected "
                     f"{sorted(tool.EXPECTED_KERNELS[name])}")
            for k, v in r["launches"].items():
                launches[k] += v * out["iters"]
        print(f"[{label}] {what}: every stage launched its kernels and no "
              f"other, device_ms <= {TOOLS_SLACK} x ms; "
              f"{time.perf_counter() - t0:.1f} s ({card})")

    cfg = CodecConfig.production(intra_qstep=QSTEP)
    sink = FrameSink()
    reset_counts()
    with tempfile.TemporaryDirectory() as tmp:
        out = bench_sustained.sustained(clips.ClipReader(frames), cfg,
                                        device="cuda", out_dir=tmp, sink=sink)
        for k, v in read_counts().items():
            launches[k] += v
        out["source"] = f"synthetic:{seed}, {W}x{H}, {len(frames)} frames"
        path = os.path.join(tmp, "out.vcs")
        with open(path, "rb") as fh:
            blob = fh.read()
        want = Decoder(device="cuda").decode(bitstream.load_vcs(path))
    print(f"[{label}] {json.dumps(out)}")
    if blob != main_vcs:
        fail(f"bench_sustained's .vcs ({len(blob)} bytes) differs from the "
             f"main path's ({len(main_vcs)} bytes)")
    if out["frames"] != len(frames) or len(sink.frames) != len(frames):
        fail(f"bench_sustained decoded {len(sink.frames)} frames of "
             f"{out['frames']}, the clip has {len(frames)}")
    if any(not np.array_equal(a, b) for a, b in zip(sink.frames, want)):
        fail("bench_sustained's decode differs from Decoder.decode of the "
             "same file")
    print(f"[{label}] bench_sustained: .vcs identical to the main path's "
          f"({len(blob)} bytes), {len(sink.frames)} frames identical to "
          f"Decoder.decode's ({card})")
    print(f"[{label}] kernel launches {launches}; phase "
          f"{time.perf_counter() - t_phase:.1f} s")
    return launches


BENCH_TIMEOUT_S = 600
BENCH_KEYS = ("production_fps_640x360", "encode_decode_fps_1280x720",
              "encode_decode_fps_1280x720_lumasearch",
              "chroma420_fps_640x352", "production_fps_1920x1080",
              "production_fps_1920x1080_lumasearch")
BENCH_PSNR_FLOOR_DB = 30.0
BARE_PLANE = ("res_y", "res_c", "bres_y", "bres_c")


def output_tensors(x, name: str = "out"):
    """(name, tensor) of every tensor of a bench step's outputs: the fields
    of the GOP records and intra payloads by name, tuples by position."""
    import dataclasses
    import torch
    if torch.is_tensor(x):
        yield name, x
    elif dataclasses.is_dataclass(x):
        for f in dataclasses.fields(x):
            if getattr(x, f.name) is not None:
                yield from output_tensors(getattr(x, f.name), f.name)
    elif hasattr(x, "_fields"):
        for k in x._fields:
            yield from output_tensors(getattr(x, k), k)
    else:
        for i, v in enumerate(x):
            yield from output_tensors(v, f"{name}[{i}]")


def step_parity(got, want, what: str) -> str:
    """Fails unless a step's outputs on the kernels are within the parity
    contract of its outputs on the plain versions: bare-plane coefficients
    +-1 on fewer than 1e-3 of them, frames (uint8) identical or +-1 on
    fewer than 1e-4 of samples, float32 (reference mode's coefficients)
    within 1e-3, every other integer (vectors, full-resolution
    coefficients, the intra payload) identical -> a summary."""
    import torch
    pairs = list(zip(output_tensors(got), output_tensors(want)))
    worst = {}
    for (name, a), (name_p, b) in pairs:
        if name != name_p or a.shape != b.shape or a.dtype != b.dtype:
            fail(f"{what}: {name} {tuple(a.shape)} {a.dtype} against the "
                 f"plain {name_p} {tuple(b.shape)} {b.dtype}")
        d = (a.double() - b.double()).abs()
        big = float(d.max()) if d.numel() else 0.0
        share = float((d != 0).double().mean()) if d.numel() else 0.0
        if name in BARE_PLANE:
            ok, kind = big <= 1 and share < 1e-3, "bare-plane"
        elif a.dtype == torch.uint8:
            ok, kind = big <= 1 and share < 1e-4, "frames"
        elif a.is_floating_point():
            ok, kind = big <= 1e-3, "float"
        else:
            ok, kind = big == 0, "integers"
        if not ok:
            fail(f"{what}: {name} ({kind}) differs from the plain version's "
                 f"by up to {big:g} on a share {share:.3e}")
        w = worst.setdefault(kind, [0.0, 0.0])
        w[0], w[1] = max(w[0], big), max(w[1], share)
    return ", ".join(f"{k} max |diff| {b:g} share {s:.2e}"
                     for k, (b, s) in worst.items())


def roll_and_sink_ms(bench, fn, n: int) -> dict:
    """The device ms (`_timing.measure`, n iterations) of the rolls and of
    the sink of one call of the bench step `fn`, each timed alone on the
    tensors that the call rolled and summed, and of the step without them
    (`bare`: inputs not rolled, no sum)."""
    import torch
    from vcs_h264_tpu_torch.tools import _timing
    seen = {"roll": [], "sink": []}
    roll, sink = bench.roll, bench.sink
    zero = torch.zeros((), dtype=torch.int64, device="cuda")
    cuda = torch.device("cuda")
    try:
        bench.roll = lambda x, it: seen["roll"].append(x) or roll(x, it)
        bench.sink = lambda *t: seen["sink"].append(t) or sink(*t)
        fn(5)
        bench.roll, bench.sink = (lambda x, it: x), (lambda *t: zero)
        bare = _timing.measure(fn, n, cuda)["device_ms"]
    finally:
        bench.roll, bench.sink = roll, sink
    return {"roll_device_ms": _timing.measure(
                lambda it: [roll(x, it) for x in seen["roll"]], n,
                cuda)["device_ms"],
            "sink_device_ms": _timing.measure(
                lambda it: [sink(*t) for t in seen["sink"]], n,
                cuda)["device_ms"],
            "bare_device_ms": bare}


def bench_phase(card: str, seed: int) -> dict:
    """Phase 12, vcs_h264_tpu_torch/bench.py on the card. In this process,
    every step of every key as `bench.keys` builds them for the bench (the
    seeded 640x360 synthetic clip, 64 frames, tiled 2x2 and 3x3): after a
    warm call, the counted call under torch.cuda.set_sync_debug_mode("warn")
    must make no host sync and launch exactly its kernels
    (`bench.EXPECTED_KERNELS`), and its outputs must be within the parity
    contract of the same call on the plain versions (`step_parity`; the
    provisional step's PSNR within PSNR_TOL_DB of the plain one's); then
    `_timing.measure` over the key's iterations (ms on the host clock,
    device ms by CUDA events), the device ms of the step's rolls and of its
    sink alone and of the step without them (`roll_and_sink_ms`), printed
    as one JSON line. Then `python -m
    vcs_h264_tpu_torch.bench` in a process of its own, its lines printed
    under [bench]: it must exit 0, and its last line hold the seven keys,
    each > 0, no extras_error and no provisional flag, the card's name as
    its device, the clip as its source and a finite psnr_capped99_db of at
    least BENCH_PSNR_FLOOR_DB. Returns the counted steps' launches."""
    import torch
    from vcs_h264_tpu_torch import bench
    from vcs_h264_tpu_torch.tools import _timing, clips

    label = "bench"
    t_phase = time.perf_counter()
    print(f"[{label}] {card}")
    frames, source = clips.source_frames(None, seed, bench.N_FRAMES)
    cuda = torch.device("cuda")
    launches = {k: 0 for k in read_counts()}
    steps = {}
    for key in bench.keys(clips.planar(frames), cuda):
        for loop, fn in key.loops.items():
            name = f"{key.name} {loop}"
            fn(0)
            torch.cuda.synchronize()
            reset_counts()
            out, _, syncs = watch_syncs(lambda: fn(5))
            torch.cuda.synchronize()
            counts = {k: v for k, v in read_counts().items() if v}
            if syncs:
                fail(f"bench step {name} synchronized with the host: {syncs}")
            if set(counts) != bench.EXPECTED_KERNELS[loop]:
                fail(f"bench step {name} launched {counts}, expected "
                     f"{sorted(bench.EXPECTED_KERNELS[loop])}")
            for k, v in counts.items():
                launches[k] += v
            t0 = time.perf_counter()
            plain = fn(5, "plain")[0]
            plain_s = time.perf_counter() - t0
            if loop == "psnr_step":
                db, db_plain = (bench.psnr_capped99(m.cpu().numpy(), len(m))
                                for m in (out[0], plain))
                if abs(db - db_plain) > PSNR_TOL_DB:
                    fail(f"bench psnr_capped99_db {db} against the plain "
                         f"versions' {db_plain}")
                parity = (f"psnr_capped99_db {db:.4f}, plain {db_plain:.4f}")
            else:
                parity = step_parity(out[0], plain, f"bench step {name}")
            del out, plain
            steps[name] = r = {**_timing.measure(fn, key.n_iters, cuda),
                               **roll_and_sink_ms(bench, fn, key.n_iters)}
            print(f"[{label}] step {name}: launches {counts}, no host sync; "
                  f"against plain ({plain_s:.1f} s): {parity}; {r['ms']:.3f}"
                  f" ms, device {r['device_ms']:.3f} ms an iteration (rolls "
                  f"{r['roll_device_ms']:.3f}, sink {r['sink_device_ms']:.3f}"
                  f", without them {r['bare_device_ms']:.3f}) ({card})")
        del key
    print(f"[{label}] {json.dumps({'steps': steps})}")

    t0 = time.perf_counter()
    lines = [json.loads(line) for line in run_tool(
        "vcs_h264_tpu_torch.bench", ["--synthetic", str(seed), "--device",
                                     "cuda"], label, BENCH_TIMEOUT_S)]
    first, last = lines[0], lines[-1]
    if not (first.get("provisional") and first["value"] == 0):
        fail(f"the bench's first line is no placeholder: {first}")
    if last["metric"] != "encode_decode_fps_640x360" or not last["value"] > 0:
        fail(f"the bench's headline: {last['metric']} = {last['value']}")
    missing = [k for k in BENCH_KEYS if not (last.get(k) or 0) > 0]
    if missing:
        fail(f"the bench's last line lacks {missing} (or they are not > 0)")
    for flag in ("extras_error", "provisional"):
        if flag in last:
            fail(f"the bench's last line carries {flag}: {last[flag]}")
    if last["device"] != torch.cuda.get_device_name(0):
        fail(f"the bench ran on {last['device']}")
    psnr = last["psnr_capped99_db"]
    if not (np.isfinite(psnr) and psnr >= BENCH_PSNR_FLOOR_DB):
        fail(f"the bench's psnr_capped99_db is {psnr}")
    if last["source"] != source:
        fail(f"the bench's source is {last['source']}, not {source}")
    print(f"[{label}] bench: the seven keys > 0, psnr_capped99_db {psnr}, "
          f"{time.perf_counter() - t0:.1f} s ({card})")
    print(f"[{label}] kernel launches {launches}; phase "
          f"{time.perf_counter() - t_phase:.1f} s")
    return launches


STANDALONE_TIMEOUT_S = 240
STANDALONE_BLOCKED = ("jax", "vcs_h264_tpu", "cv2")

# The stand-alone run: the package copy's own kernels and range coder built
# (a RuntimeWarning there, the coder's failed build, is an error), the
# clip encoded on the card in the main path's configuration and written to
# argv[1]; one JSON line.
_STANDALONE = """
import importlib.abc
import json
import os
import sys
import time
import warnings

BLOCKED = %(blocked)r


class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"{name} is refused in the stand-alone run")
        return None


sys.meta_path.insert(0, Refuse())
t0 = time.perf_counter()
import torch
torch.set_num_threads(2)
from vcs_h264_tpu_torch import CodecConfig
from vcs_h264_tpu_torch.io import bitstream
from vcs_h264_tpu_torch.models import Encoder
from vcs_h264_tpu_torch.ops import _build, inter_cuda, intra_cuda, motion_cuda
from vcs_h264_tpu_torch.tools.clips import synthetic_clip

torch.zeros(1, device="cuda")
with warnings.catch_warnings():
    warnings.simplefilter("error", RuntimeWarning)
    t1 = time.perf_counter()
    _build.load_library()
    t2 = time.perf_counter()
    loaded = bitstream.native_loaded()
    t3 = time.perf_counter()
frames = synthetic_clip(%(seed)d, %(n)d)
t4 = time.perf_counter()
video = Encoder(CodecConfig.production(intra_qstep=%(qstep)d),
                device="cuda").encode_frames(frames)
bitstream.save_vcs(video, sys.argv[1])
torch.cuda.synchronize()
t5 = time.perf_counter()
print("[standalone record] " + json.dumps(dict(
    pkg=os.path.dirname(os.path.dirname(bitstream.__file__)),
    cuda_library=str(_build.library_path()), nvcc_s=_build.build_seconds,
    native_loaded=loaded,
    native_src=str(bitstream.NATIVE_SRC),
    native_library=str(bitstream.native_library_path()), gxx_s=t3 - t2,
    start_s=t1 - t0, clip_s=t4 - t3, encode_save_s=t5 - t4,
    launches={k: v for c in (motion_cuda.LAUNCHES, inter_cuda.LAUNCHES,
                             intra_cuda.LAUNCHES) for k, v in c.items()})))
"""


def standalone_phase(card: str, seed: int, main_vcs: bytes) -> dict:
    """Phase 13, the package with nothing of the repository beside it:
    `vcs_h264_tpu_torch/` copied without its `build/` into a temporary
    directory and run there in a process of its own whose import path is
    that directory alone, with jax, vcs_h264_tpu and cv2 refused. The copy
    builds its CUDA library (nvcc) and its .vcs range coder (g++) from its
    own sources and writes the main path's .vcs of the clip. Fails unless
    the process exits 0 within the time limit, the range coder loaded
    there, both libraries lie under the copy, the CUDA library has the
    name of this process's, K2, K3 and K5 launched, and the bytes equal the
    main path's .vcs of this run. Prints both build times and the wall
    time. Returns the copy's launches."""
    from vcs_h264_tpu_torch.ops import _build
    label = "standalone"
    with tempfile.TemporaryDirectory() as tmp:
        pkg = os.path.join(tmp, "vcs_h264_tpu_torch")
        shutil.copytree(_build._PKG, pkg, ignore=shutil.ignore_patterns(
            "build", "__pycache__"))
        path = os.path.join(tmp, "standalone.vcs")
        script = _STANDALONE % dict(blocked=STANDALONE_BLOCKED, seed=seed,
                                    n=CLIP_FRAMES, qstep=QSTEP)
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(
                [sys.executable, "-c", script, path], cwd=tmp,
                env={**os.environ, "PYTHONPATH": tmp}, capture_output=True,
                text=True, timeout=STANDALONE_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            fail(f"the stand-alone run took over {STANDALONE_TIMEOUT_S} s")
        wall = time.perf_counter() - t0
        if proc.returncode:
            fail(f"the stand-alone run exited {proc.returncode}: "
                 f"{proc.stdout[-2000:]}{proc.stderr[-2000:]}")
        tag = "[standalone record] "
        lines = [x for x in proc.stdout.splitlines() if x.startswith(tag)]
        if not lines:
            fail(f"the stand-alone run printed no record: {proc.stdout}")
        rec = json.loads(lines[-1][len(tag):])
        with open(path, "rb") as fh:
            blob = fh.read()
    under = pkg + os.sep
    if not rec["native_loaded"]:
        fail(f"the stand-alone run coded .vcs without the native coder: "
             f"{rec}")
    if rec["pkg"] != pkg or not all(
            rec[k].startswith(under)
            for k in ("cuda_library", "native_src", "native_library")):
        fail(f"the stand-alone run used files outside its copy: {rec}")
    if os.path.basename(rec["cuda_library"]) != _build.library_path().name:
        fail(f"the copy's CUDA library is {rec['cuda_library']}, not "
             f"{_build.library_path().name}")
    if rec["nvcc_s"] is None:
        fail("the copy's CUDA library was not built from its sources")
    launches = rec["launches"]
    if any(not launches[k] for k in ("sad_search", "fused_p_encode",
                                     "intra_encode")):
        fail(f"the stand-alone encode launched {launches}")
    if blob != main_vcs:
        fail(f"the stand-alone .vcs ({len(blob)} bytes) differs from the "
             f"main path's ({len(main_vcs)} bytes)")
    print(f"[{label}] the package alone (jax, vcs_h264_tpu, cv2 refused): "
          f"nvcc {rec['nvcc_s']:.2f} s -> "
          f"{os.path.basename(rec['cuda_library'])}, g++ "
          f"{rec['gxx_s']:.2f} s -> "
          f"{os.path.basename(rec['native_library'])}; start-up "
          f"{rec['start_s']:.2f} s, clip {rec['clip_s']:.2f} s, encode and "
          f"save {rec['encode_save_s']:.2f} s; .vcs {len(blob)} bytes "
          f"identical to the main path's; wall {wall:.2f} s ({card})")
    print(f"[{label}] kernel launches "
          f"{ {k: v for k, v in launches.items() if v} }")
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="profile each path once instead of checking")
    ap.add_argument("--earlier", metavar="DIR",
                    help="time the K1 to K7 of the sources in DIR as well")
    ap.add_argument("--dist-rank", type=int, default=None,
                    help="run as this rank of the distributed phase")
    ap.add_argument("--dist-world", type=int, default=DIST_WORLD)
    ap.add_argument("--dist-coordinator", default=None)
    ap.add_argument("--dist-dir", default=None)
    args = ap.parse_args()
    if args.dist_rank is not None:
        return dist_rank_main(args)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from vcs_h264_tpu_torch.ops import _build
    from vcs_h264_tpu_torch.tools.clips import synthetic_clip

    # phase 1: the card
    card = card_line()
    print(f"[card] {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # phase 2: build
    t0 = time.perf_counter()
    _build.load_library()
    print(f"[build] {time.perf_counter() - t0:.2f} s "
          f"({'nvcc' if _build.build_seconds is not None else 'cached'}) -> "
          f"{_build.library_path().name}")
    from vcs_h264_tpu_torch.io import bitstream
    t0 = time.perf_counter()
    if not bitstream.native_loaded():
        fail("g++ could not build the .vcs range coder "
             f"({bitstream.NATIVE_SRC})")
    print(f"[build] .vcs range coder {time.perf_counter() - t0:.2f} s -> "
          f"{bitstream.native_library_path().name}")

    if args.earlier:
        load_earlier(args.earlier)
    frames = synthetic_clip(args.seed, CLIP_FRAMES)
    if args.profile:
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]):   # its start-up
            torch.zeros(1, device="cuda")
        for cfg, label, _ in main_paths():
            profile_path(frames, card, cfg, label)
        return 0

    edge_shape_phase()
    fused_decode_edge_phase()
    fused_encode_edge_phase()
    search_edge_phase()
    geometries, geometry_launches = search_geometry_phase(frames, card)
    intra_edge_phase()
    decode_edge_phase()
    compensate_edge_phase()
    plane_edge_phase()
    kernels = kernel_phase(frames, card)
    kernels["sad_search"]["geometries"] = geometries
    i_frames = np.stack(frames[:GOPS * (P_PER_GOP + 1):P_PER_GOP + 1])
    kernels.update(intra_kernel_phase(
        torch.from_numpy(i_frames).cuda().permute(0, 3, 1, 2)
        .reshape(-1, H, W).contiguous(), card))             # [24, H, W]
    intra_tall_phase(card)
    kernels.update(compensate_kernel_phase(frames, card))
    kernels.update(plane_kernel_phase(frames, card))
    legacy_vcs_phase(card)

    launches = {}
    for cfg, label, kw in main_paths():
        for k, v in main_path_phase(frames, card, cfg, label, **kw).items():
            launches[k] = launches.get(k, 0) + v
    for k, v in geometry_launches.items():
        launches[k] += v
    for k, v in stream_phase(frames, card).items():
        launches[k] += v
    for k, v in study_phase(frames, card).items():
        launches[k] += v
    cli_launches, single_vcs, single_s = cli_phase(frames, card, args.seed)
    for k, v in cli_launches.items():
        launches[k] += v
    for k, v in distributed_phase(card, args.seed, single_vcs,
                                  single_s).items():
        launches[k] += v
    for k, v in spatial_phase(frames, card).items():
        launches[k] += v
    for k, v in tools_phase(frames, card, args.seed, single_vcs).items():
        launches[k] += v
    for k, v in bench_phase(card, args.seed).items():
        launches[k] += v
    for k, v in standalone_phase(card, args.seed, single_vcs).items():
        launches[k] += v

    meta = {
        "compensate": ("vcs_h264_tpu_torch/csrc/motion_comp.cu",
                       "vcs_h264_tpu/ops/motion_pallas.py:287"),
        "sad_search": ("vcs_h264_tpu_torch/csrc/motion_sad.cu",
                       "vcs_h264_tpu/ops/motion_pallas.py:80"),
        "fused_p_encode": ("vcs_h264_tpu_torch/csrc/inter_fused.cu",
                           "vcs_h264_tpu/ops/inter_pallas.py:387"),
        "fused_p_decode": ("vcs_h264_tpu_torch/csrc/inter_fused.cu",
                           "vcs_h264_tpu/ops/inter_pallas.py:413"),
        "intra_encode": ("vcs_h264_tpu_torch/csrc/intra_wavefront.cu",
                         "vcs_h264_tpu/ops/intra_pallas.py:341"),
        "intra_decode": ("vcs_h264_tpu_torch/csrc/intra_wavefront.cu",
                         "vcs_h264_tpu/ops/intra_pallas.py:381"),
        "plane_encode": ("vcs_h264_tpu_torch/csrc/inter_plane.cu",
                         "vcs_h264_tpu/ops/inter_pallas.py:387"),
        "plane_decode": ("vcs_h264_tpu_torch/csrc/inter_plane.cu",
                         "vcs_h264_tpu/ops/inter_pallas.py:413"),
        "c420_encode": ("vcs_h264_tpu_torch/csrc/inter_plane.cu",
                        "vcs_h264_tpu/ops/inter_pallas.py:469"),
        "c420_decode": ("vcs_h264_tpu_torch/csrc/inter_plane.cu",
                        "vcs_h264_tpu/ops/inter_pallas.py:493"),
    }
    record = [dict(name=name, route="cuda", source=src, replaces=rep,
                   launches=launches[name], **kernels[name])
              for name, (src, rep) in meta.items()]
    print(card)
    print(json.dumps({"kernels": record}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
