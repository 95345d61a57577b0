"""Figures of the card the port targets: one NVIDIA H100 SXM.

Stands in for the TPU constants of ``repro.launch.mesh``
(``PEAK_FLOPS_BF16``/``HBM_BW``, ``launch/mesh.py:95-98``), which the JAX
package's roofline platform and bottleneck diagnosis read.  Dense rates
without sparsity, from NVIDIA's data sheet, at the full 700 W power limit.
"""
PEAK_FLOPS_BF16 = 989e12        # tensor cores, dense bf16
PEAK_FLOPS_F32 = 67e12          # CUDA cores, f32 FMA (no TF32)
HBM_BW = 3.35e12                # bytes/s, 80 GB HBM3
SMEM_PER_BLOCK = 232_448        # bytes of shared memory one block may use
SMS = 132                       # streaming multiprocessors
