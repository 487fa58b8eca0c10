from repro_torch.configs.paper_models import (PAPER_MODELS,  # noqa: F401
                                              PaperModelConfig, SINE_MLP)
