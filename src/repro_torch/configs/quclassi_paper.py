"""The paper's own workload configs: QuClassi quantum-classical CNN at the
evaluated qubit/layer settings (§IV-A), e.g. ``quclassi-7q-3l``."""
from repro_torch.core.quclassi import QuClassiConfig
from repro_torch.core.segmentation import SegmentationConfig

QUCLASSI_CONFIGS: dict[str, QuClassiConfig] = {}

for qc in (5, 7):
    for nl in (1, 2, 3):
        QUCLASSI_CONFIGS[f"quclassi-{qc}q-{nl}l"] = QuClassiConfig(
            qc=qc, n_layers=nl,
            seg=SegmentationConfig(filter_width=4, stride=2, n_filters=4),
            image_size=(8, 8),
        )


def get_quclassi(name: str) -> QuClassiConfig:
    return QUCLASSI_CONFIGS[name]
