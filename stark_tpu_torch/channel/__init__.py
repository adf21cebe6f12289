"""The Fiat-Shamir channel: the host transcript, the device state (K5's
chain form) and the device query phase (K5's query form)."""

from stark_tpu_torch.channel.channel import (Channel, ChannelError,
                                             VerifierChannel)

__all__ = ["Channel", "VerifierChannel", "ChannelError"]
