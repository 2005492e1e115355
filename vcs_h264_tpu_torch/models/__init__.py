"""GOP pipeline, encoder, decoder and the encoded-stream container."""

from vcs_h264_tpu_torch.models.decoder import Decoder
from vcs_h264_tpu_torch.models.encoder import Encoder
from vcs_h264_tpu_torch.models.gop import EncodedGOP, EncodedVideo

__all__ = ["Decoder", "EncodedGOP", "EncodedVideo", "Encoder"]
