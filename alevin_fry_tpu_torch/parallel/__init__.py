"""Multi-device runs (port of ``alevin_fry_tpu/parallel/``): the
host-array layer ``dist`` over ``torch.distributed`` for several
processes, and ``mesh``, the device mesh of one process."""
