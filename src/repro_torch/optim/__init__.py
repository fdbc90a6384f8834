"""AdamW, its schedule and global-norm clipping (port of ``repro.optim``)."""
from .adamw import (OptConfig, adamw_update, clip_by_global_norm,
                    global_norm, init_opt_state, schedule)
