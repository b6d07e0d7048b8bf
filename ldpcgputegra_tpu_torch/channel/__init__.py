"""Channel stages: AWGN with BPSK/QPSK (the encoders are not ported yet)."""

from .awgn import AwgnChannel, ChannelSpec, sigma_for_snr

__all__ = ["AwgnChannel", "ChannelSpec", "sigma_for_snr"]
