"""Published and derived peaks of one NVIDIA H100 SXM at its 700 W limit,
the denominators of the roofline shares."""

# NVIDIA H100 data sheet (SXM part, dense): float32 outside the tensor
# cores, and HBM3 bandwidth
FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
# special-function (MUFU: rsqrt, sqrt, exp) results per second, derived and
# not published: 16 per clock per SM (CUDA C++ Programming Guide,
# arithmetic instruction throughput, compute capability 9.0) x 132 SMs x
# 1.98 GHz boost clock
MUFU_PER_S = 132 * 16 * 1.98e9

PEAKS = {"fp32_flops": FP32_FLOPS, "hbm_bytes_per_s": HBM_BYTES_PER_S,
         "mufu_per_s": MUFU_PER_S}
