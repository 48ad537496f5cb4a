"""Backbone towers of the PyTorch port."""

from bifold_tpu_torch.models.backbones.clip_backbone import (  # noqa: F401
    CLIP_CONFIGS,
    CLIP_TEXT_CONFIGS,
    ClipBackbone,
    ClipConfig,
)
from bifold_tpu_torch.models.backbones.siglip_backbone import (  # noqa: F401
    SIGLIP_BASE_CONFIGS,
    SiglipBackbone,
    SiglipConfig,
)
from bifold_tpu_torch.models.backbones.t5_backbone import (  # noqa: F401
    T5_CONFIGS,
    T5Config,
    T5Encoder,
    resolve_t5_config,
)
