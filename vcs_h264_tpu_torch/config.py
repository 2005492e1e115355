"""Codec configuration, field for field the JAX package's `CodecConfig`
(`vcs_h264_tpu/config.py`).

The class is defined here rather than imported so that the port, and
`chip_smoke.py` which drives it, load nothing of the JAX package: the GPU
machine runs the port without it. `tests/test_torch_ops.py` holds the two
definitions equal (fields, defaults, presets and validation), so a change to
one that is not made to the other fails the suite.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class CodecConfig:
    """All codec knobs. Defaults = the reference's operating point; see
    `vcs_h264_tpu/config.py` for what each knob means."""

    block_size: int = 8
    gop_pattern: Tuple[str, ...] = ("I", "P", "P", "P")
    search_reach: int = 16
    static_threshold: int = 2000
    search_step: int = 3
    search_luma_only: bool = False
    quality_factor: float = 50.0
    with_residual: bool = True
    with_dct: bool = True
    quant_mode: str = "reference"
    intra_i: bool = False
    intra_qstep: int = 0
    signed_residual: bool = True
    chroma_420: bool = False
    dtype: str = "float32"

    def __post_init__(self):
        if self.block_size < 2:
            raise ValueError(f"block_size must be >= 2, got {self.block_size}")
        if self.with_dct and self.block_size != 8:
            raise ValueError(
                f"with_dct requires block_size=8 (8x8 JPEG quantization "
                f"tables), got {self.block_size}. Use with_dct=False for "
                f"the block-size sweep; the reference's sweep used "
                f"search_reach=2*block_size and search_step=round("
                f"block_size/3) (motion.py:18,132).")
        if not self.gop_pattern or self.gop_pattern[0] != "I":
            raise ValueError("gop_pattern must start with 'I'")
        if any(t not in ("I", "P", "B") for t in self.gop_pattern):
            raise ValueError(f"unknown frame types in {self.gop_pattern}")
        if "I" in self.gop_pattern[1:]:
            raise ValueError("only the first frame of a GOP may be I")
        if "B" in self.gop_pattern and self.gop_pattern[-1] == "B":
            raise ValueError(
                "a GOP pattern with B frames must end with an anchor (P) so "
                "every B has a backward reference inside its own GOP")
        if not (1 <= self.quality_factor <= 99):
            raise ValueError("quality_factor must be in [1, 99]")
        if self.quant_mode not in ("reference", "rounded"):
            raise ValueError(f"unknown quant_mode {self.quant_mode!r}")
        if not (0 <= self.intra_qstep <= 255):
            raise ValueError("intra_qstep must be in [0, 255]")
        if self.intra_qstep and not self.intra_i:
            raise ValueError("intra_qstep > 0 requires intra_i=True")
        if self.chroma_420:
            if self.quant_mode != "rounded" or not self.with_dct \
                    or not self.with_residual:
                raise ValueError(
                    "chroma_420 requires the production path (quant_mode="
                    "'rounded', with_dct, with_residual): wrap-residual "
                    "semantics are a full-res reference-parity feature")

    @property
    def gop_len(self) -> int:
        return len(self.gop_pattern)

    @property
    def frames_per_gop_p(self) -> int:
        return self.gop_len - 1

    @property
    def has_b(self) -> bool:
        return "B" in self.gop_pattern

    @property
    def num_b(self) -> int:
        return sum(1 for t in self.gop_pattern if t == "B")

    @classmethod
    def reference(cls, **overrides) -> "CodecConfig":
        """The exact reference operating point (bit-parity mode)."""
        return cls(**overrides)

    @classmethod
    def bframes(cls, **overrides) -> "CodecConfig":
        """GOP I,B,P,B,P,B,P with bidirectional prediction."""
        kw = dict(gop_pattern=("I", "B", "P", "B", "P", "B", "P"))
        kw.update(overrides)
        return cls(**kw)

    @classmethod
    def production(cls, **overrides) -> "CodecConfig":
        """Rounded-quant bitstream mode (real compression), intra-coded
        I-frames."""
        kw = dict(quant_mode="rounded", intra_i=True)
        kw.update(overrides)
        return cls(**kw)

