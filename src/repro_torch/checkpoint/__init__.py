from repro_torch.checkpoint.ckpt import (latest_checkpoint,  # noqa: F401
                                         list_checkpoints, load_params,
                                         restore_checkpoint,
                                         verify_checkpoint)
