"""Data parallel over ``torch.distributed`` ranks (``mesh.py``)."""
from .mesh import (DataGroup, active, average_grads, draw_rows, gather_rows,
                   is_writer, launch, launch_for, maybe_init_distributed,
                   process_group, process_slice, setup_data_parallel,
                   unsharded)
