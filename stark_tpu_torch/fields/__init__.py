"""Prime fields: the scalar host mirror and the batched torch context."""

from stark_tpu_torch.fields.element import FieldElement, fe
from stark_tpu_torch.fields.fp import Fp

__all__ = ["FieldElement", "fe", "Fp"]
