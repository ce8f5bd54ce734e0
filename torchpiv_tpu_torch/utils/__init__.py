"""Device resolution and synthetic test data."""


def free_device_memory():
    """Release the blocks the CUDA caching allocator holds for reuse
    (``torch.cuda.empty_cache``): the counterpart of the reference's
    ``free_cuda_memory`` (PIVbackend.py:83-85).  Tensors still referenced
    keep their memory; before CUDA is initialised it does nothing."""
    import torch

    torch.cuda.empty_cache()
