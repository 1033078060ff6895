from repro_torch.checkpoint.checkpoint import (  # noqa: F401
    SCHEMA_VERSION, checkpoint_checksum, load_checkpoint, save_checkpoint)
