"""vcs_h264_tpu_torch: the codec of `vcs_h264_tpu` in PyTorch, with its
TPU kernels rewritten as CUDA kernels for NVIDIA Hopper (sm_90a).

The JAX package stays the reference. This package covers the codec at full
resolution and in 4:2:0: reference-parity mode (`CodecConfig()`, also
with_dct=False at any block size and with_residual=False), the production
path (`CodecConfig.production()`) with raw or lossy intra I-frames, B-frame
patterns in either (`CodecConfig.bframes()`), the luma-only search
(`search_luma_only`) and the 4:2:0 mode (`chroma_420`, with or without
B-frames and lossy intra) and the legacy unsigned residual of the
version-3 container (`signed_residual=False`): `Encoder.encode_frames` ->
`io.bitstream.save_vcs` / `load_vcs` (the range-coded `.vcs` container) or
`EncodedVideo.save_npz` / `load_npz` -> `Decoder.decode`, plus the intra
codec of `models.intra_codec`; and the streaming path from video file to
video file: `Encoder.encode_video` / `encode_stream` with per-GOP
checkpoints, metrics and stage timings, `Decoder.iter_frames` /
`decode_to_file`.

Layout:
  config.py   CodecConfig (field for field the JAX package's)
  ops/        blocks, color, subsample, dct, quant (tables, zigzag), motion
              and intra (plain PyTorch), motion_cuda, inter_cuda and
              intra_cuda (kernel
              wrappers, with the plain versions of K3/K4/K7 in inter_cuda),
              _build (nvcc)
  csrc/       the CUDA kernels
  models/     gop (.npz container), pipeline, pipeline420, intra_codec,
              encoder (checkpoints, hooks, streaming), decoder, host_path
              (pinned staging and copy streams)
  io/         bitstream (.vcs container: the range coder, native/bitstream.cpp
              built with g++, and its Python mirror), video (cv2 reader and
              writer, imported inside)
  utils/      metrics (PSNR, SSIM, sparsity, JSONL logger), profiling
              (trace ranges, device_trace, StageTimer)
  interop.py  encoded streams to and from the JAX package
"""

from vcs_h264_tpu_torch.config import CodecConfig

__all__ = ["CodecConfig"]
