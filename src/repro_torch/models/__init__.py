"""Models of the port: the GraphIR decoder LM (:mod:`.graph_lm`), the
layer-stack decoder LM (:mod:`.lm` over :mod:`.stack`), the
encoder-decoder (:mod:`.encdec`) and the paper's five evaluation CNNs
(:mod:`.cnn`)."""

from repro_torch.models.encdec import EncDec  # noqa: F401
from repro_torch.models.lm import LM  # noqa: F401
