"""The paper's own 5-layer CNN example (50-80-120-200-350 channels, 5x5
filters, INT8 activations, group 1): the reproduction target, as
``repro.configs.paper_cnn`` defines it.  Not an LM architecture, so it is
not in the ``--arch`` registry."""

from repro_torch.core.quantization import QuantSpec
from repro_torch.models.cnn import PaperCNN


def config(*, device="cuda"):
    return PaperCNN(in_channels=1, n_classes=10,
                    act_spec=QuantSpec(bits=8), group=1, device=device)


def smoke_config(*, device="cuda"):
    return PaperCNN(in_channels=1, n_classes=10, channels=(8, 12),
                    act_spec=QuantSpec(bits=2), group=1, device=device)
