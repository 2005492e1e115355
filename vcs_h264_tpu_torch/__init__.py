"""vcs_h264_tpu_torch: the codec of `vcs_h264_tpu` in PyTorch, with its
TPU kernels rewritten as CUDA kernels for NVIDIA Hopper (sm_90a).

The JAX package stays the reference. This package covers the full-resolution
codec: reference-parity mode (`CodecConfig()`, also with_dct=False at any
block size and with_residual=False), the production path
(`CodecConfig.production()`) with raw or lossy intra I-frames, and B-frame
patterns in either (`CodecConfig.bframes()`): `Encoder.encode_frames` ->
`EncodedVideo.save_npz` / `load_npz` -> `Decoder.decode`, plus the intra
codec of `models.intra_codec`. Other modes (4:2:0, luma-only search, the
legacy unsigned residual) raise NotImplementedError (ROADMAP.md).

Layout:
  config.py   CodecConfig (field for field the JAX package's)
  ops/        blocks, color, dct, quant, motion and intra (plain
              PyTorch), motion_cuda, inter_cuda and intra_cuda (kernel
              wrappers, with the plain versions of K3/K4 in inter_cuda),
              _build (nvcc)
  csrc/       the CUDA kernels
  models/     gop (container), pipeline, intra_codec, encoder, decoder
  utils/      metrics
  interop.py  encoded streams to and from the JAX package
"""

from vcs_h264_tpu_torch.config import CodecConfig

__all__ = ["CodecConfig"]
