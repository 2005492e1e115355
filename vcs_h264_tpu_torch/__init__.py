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
`decode_to_file`; the GOP axis across processes (`parallel`: each rank
encodes its GOP span into a shared checkpoint directory, rank 0 assembles
the stream); the command-line driver (`cli`: encode, decode, roundtrip and
the intra, DCT and chroma studies, with `--device`); and the study
functions and single-frame wrappers of `ops` (the open-loop intra studies,
the single-plane intra codec, the one-frame motion search and
compensation, the blockwise DCT of a plane, the chroma study's round trip).

Layout:
  config.py   CodecConfig (field for field the JAX package's)
  ops/        blocks, color, subsample, dct, quant (tables, zigzag), motion
              and intra (plain PyTorch, the studies and the single-frame
              wrappers), motion_cuda, inter_cuda and intra_cuda (kernel
              wrappers, with the plain versions of K3/K4/K7 in inter_cuda),
              _build (nvcc)
  csrc/       the CUDA kernels, and the .vcs range coder's C++ source
  models/     gop (.npz container), pipeline, pipeline420, intra_codec,
              encoder (checkpoints, hooks, streaming), decoder, host_path
              (pinned staging and copy streams)
  io/         bitstream (.vcs container: the range coder, csrc/bitstream.cpp
              built with g++, and its Python mirror), video (cv2 reader and
              writer, imported inside)
  utils/      metrics (PSNR, SSIM, sparsity, JSONL logger), profiling
              (trace ranges, device_trace, StageTimer)
  parallel/   distributed (the process group on a store, the barrier, GOP
              spans, the merge of checkpoint directories, the encode)
  cli.py      the command-line driver: cores on frames and streams, and a
              file layer with cv2 imported inside
  interop.py  encoded streams to and from the JAX package
"""

from vcs_h264_tpu_torch.config import CodecConfig

__all__ = ["CodecConfig"]
