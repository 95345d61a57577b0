"""Figures of the card the port targets: one NVIDIA H100 SXM.

Stands in for the TPU constants of ``repro.launch.mesh``
(``PEAK_FLOPS_BF16``/``HBM_BW``/``ICI_BW``/``HBM_BYTES``,
``launch/mesh.py:95-98``), which the JAX package's roofline platform,
bottleneck diagnosis and dry run read.  Dense rates without sparsity, from
NVIDIA's data sheet, at the full 700 W power limit.
"""
PEAK_FLOPS_BF16 = 989e12        # tensor cores, dense bf16
PEAK_FLOPS_F32 = 67e12          # CUDA cores, f32 FMA (no TF32)
HBM_BW = 3.35e12                # bytes/s, 80 GB HBM3
SMEM_PER_BLOCK = 232_448        # bytes of shared memory one block may use
SMS = 132                       # streaming multiprocessors
# torch.cuda.get_device_properties(0).total_memory on an NVIDIA H100 80GB
# HBM3 at a 700 W power limit (torch 2.11.0+cu128): the dry run's fit test
HBM_BYTES = 85_017_493_504
# bytes/s a rank sends on the collective term: one 400 Gb/s NDR InfiniBand
# port per GPU (NVIDIA DGX H100 data sheet).  Every group of the 16 x 16
# production mesh spans nodes of 8 GPUs (the model axis is 16 consecutive
# ranks, the data axis has stride 16), so a ring over either axis runs at
# the network's rate, not NVLink's
LINK_BW = 50e9
