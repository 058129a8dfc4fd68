"""The paper's own surrogate models (PtychoNN, AutoPhaseNN, CosmoFlow).

These drive the SOLAR benchmark tables.  They are CNNs, described by
:class:`SurrogateConfig` (separate from the LM :class:`ModelConfig`) and
implemented in :mod:`repro_torch.models.cnn`.  Own copy of
``repro.configs.surrogates``: the same configurations, field for field.
"""
from __future__ import annotations

import dataclasses

__all__ = ["SurrogateConfig", "SURROGATES"]


@dataclasses.dataclass(frozen=True)
class SurrogateConfig:
    name: str
    kind: str            # 'ptychonn' | 'autophasenn' | 'cosmoflow'
    input_shape: tuple   # per-sample input shape
    output_shape: tuple
    base_channels: int
    depth: int           # encoder stages

    def reduced(self) -> "SurrogateConfig":
        return dataclasses.replace(
            self,
            input_shape=tuple(min(s, 16) if s > 4 else s for s in self.input_shape),
            output_shape=tuple(min(s, 16) if s > 4 else s for s in self.output_shape),
            base_channels=min(self.base_channels, 8),
            depth=min(self.depth, 2),
        )


SURROGATES: dict[str, SurrogateConfig] = {
    # PtychoNN (Cherukara et al. 2020): 2D autoencoder, 64x64 diffraction in,
    # amplitude+phase out; ~1.2M params at base_channels=32.
    "ptychonn": SurrogateConfig(
        name="ptychonn",
        kind="ptychonn",
        input_shape=(64, 64, 1),
        output_shape=(64, 64, 2),
        base_channels=64,   # ~0.9M params — PtychoNN scale (paper: 1.2M)
        depth=3,
    ),
    # AutoPhaseNN (Yao et al. 2022): 3D BCDI encoder-decoder, 32^3 in.
    "autophasenn": SurrogateConfig(
        name="autophasenn",
        kind="autophasenn",
        input_shape=(32, 32, 32, 1),
        output_shape=(32, 32, 32, 2),
        base_channels=16,
        depth=3,
    ),
    # CosmoFlow (Mathuriya et al. 2018): 3D CNN regressor, 128^3 x 4 in,
    # 4 cosmological parameters out.
    "cosmoflow": SurrogateConfig(
        name="cosmoflow",
        kind="cosmoflow",
        input_shape=(64, 64, 64, 4),
        output_shape=(4,),
        base_channels=16,
        depth=4,
    ),
}
