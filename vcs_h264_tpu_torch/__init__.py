"""vcs_h264_tpu_torch: the codec of `vcs_h264_tpu` in PyTorch, with its
TPU kernels rewritten as CUDA kernels for NVIDIA Hopper (sm_90a).

The JAX package stays the reference. This package covers the production
IPPP path with raw I-frames (`CodecConfig.production()`, intra_qstep 0):
`Encoder.encode_frames` -> `EncodedVideo.save_npz` / `load_npz` ->
`Decoder.decode`. Other modes raise NotImplementedError (ROADMAP.md).

Layout:
  config.py   CodecConfig (field for field the JAX package's)
  ops/        blocks, dct, quant, motion (plain PyTorch), motion_cuda and
              inter_cuda (kernel wrappers + plain versions), _build (nvcc)
  csrc/       the CUDA kernels
  models/     gop (container), pipeline, encoder, decoder
  utils/      metrics
  interop.py  encoded streams to and from the JAX package
"""

from vcs_h264_tpu_torch.config import CodecConfig

__all__ = ["CodecConfig"]
