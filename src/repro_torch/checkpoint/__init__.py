from repro_torch.checkpoint.checkpoint import (CheckpointManager,
                                               load_checkpoint,
                                               save_checkpoint)
