"""Multi-process runs (port of ``alevin_fry_tpu/parallel/``): the
host-array layer ``dist`` over ``torch.distributed``."""
