"""Channel stages: AWGN with BPSK/QPSK, the encoders and the info-bit
generator."""

from .awgn import AwgnChannel, ChannelSpec, sigma_for_snr
from .bitgen import generate_info_bits
from .encoder import (
    FakeEncoder,
    GF2Encoder,
    QCAccumulateEncoder,
    StaircaseEncoder,
    make_encoder,
)

__all__ = ["AwgnChannel", "ChannelSpec", "sigma_for_snr",
           "generate_info_bits", "FakeEncoder", "GF2Encoder",
           "QCAccumulateEncoder", "StaircaseEncoder", "make_encoder"]
