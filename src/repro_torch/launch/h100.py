"""NVIDIA H100 SXM5 constants: the one source of the port's roofline
(``launch/roofline.py``) and of ``chip_smoke.py``'s kernel bounds.

Source: the NVIDIA H100 Tensor Core GPU datasheet, SXM5 column (dense
rates, without sparsity). The collective rate is one 400 Gb/s NDR
InfiniBand port per GPU, as in an HGX H100 system with one ConnectX-7
per GPU: both axes of the (16, 16) production mesh span more than one
8-GPU node, so a collective over either axis crosses that port.
"""

PEAK_BF16_FLOPS = 989e12        # dense bf16 tensor-core FLOP/s
PEAK_TF32_FLOPS = 495e12        # dense TF32 tensor-core FLOP/s
PEAK_F32_FLOPS = 67e12          # float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12       # HBM3 bandwidth
HBM_BYTES = 80e9                # HBM3 capacity
COLLECTIVE_BYTES_PER_S = 50e9   # 400 Gb/s NDR, one port per GPU
# NVLink 4 within an 8-GPU node, per direction: named beside the rate
# above and not used (no mesh axis here fits inside one node)
NVLINK_BYTES_PER_S = 450e9
