"""Config registry of the port: the paper's tiny models and the LM
architectures (importing this package registers them)."""
from repro_torch.configs.base import (ArchConfig, get_arch,  # noqa: F401
                                      list_archs, register)
from repro_torch.configs.shapes import (SHAPES, InputShape,  # noqa: F401
                                        get_shape)
from repro_torch.configs.glm4_9b import GLM4_9B  # noqa: F401
from repro_torch.configs.llama4_maverick_400b_a17b import (  # noqa: F401
    LLAMA4_MAVERICK)
from repro_torch.configs.mamba2_130m import MAMBA2_130M  # noqa: F401
from repro_torch.configs.minicpm_2b import MINICPM_2B  # noqa: F401
from repro_torch.configs.mixtral_8x22b import MIXTRAL_8X22B  # noqa: F401
from repro_torch.configs.paligemma_3b import PALIGEMMA_3B  # noqa: F401
from repro_torch.configs.paper_models import (PAPER_MODELS,  # noqa: F401
                                              PaperModelConfig, SINE_MLP)
from repro_torch.configs.starcoder2_15b import STARCODER2_15B  # noqa: F401
from repro_torch.configs.tinyllama_1_1b import TINYLLAMA_1_1B  # noqa: F401
from repro_torch.configs.whisper_tiny import WHISPER_TINY  # noqa: F401
from repro_torch.configs.zamba2_1_2b import ZAMBA2_1_2B  # noqa: F401

#: every architecture the JAX package registers, all ported
ALL_ARCHS = (
    "llama4-maverick-400b-a17b", "mamba2-130m", "mixtral-8x22b",
    "whisper-tiny", "tinyllama-1.1b", "glm4-9b", "zamba2-1.2b",
    "minicpm-2b", "paligemma-3b", "starcoder2-15b",
)
