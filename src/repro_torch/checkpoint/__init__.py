from repro_torch.checkpoint.ckpt import (AsyncCheckpointWriter,  # noqa: F401
                                         RoundState, latest_checkpoint,
                                         list_checkpoints, load_params,
                                         restore_checkpoint,
                                         restore_round_state,
                                         save_checkpoint, save_round_state,
                                         verify_checkpoint)
