"""Published peaks of one NVIDIA H100 SXM (dense, 700 W): HBM3 at 3.35 TB/s,
989 TFLOP/s bf16 on the tensor cores, 67 TFLOP/s float32 off them, and the
special function units' 16 exps per SM and clock on 132 SMs at the 1980 MHz
boost clock."""

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}
SM_CLOCK_HZ = 1980e6
EXPS_PER_S = 16 * 132 * SM_CLOCK_HZ
ELEMENT_BYTES = {"bf16": 2, "f32": 4}
