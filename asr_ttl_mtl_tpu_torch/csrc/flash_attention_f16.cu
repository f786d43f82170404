// The fp16 serving forwards (`flash_h2_fwd_f16`, `flash_mh_fwd_f16`,
// `flash_fwd_f16`: K3, K5 and K7 without the logsumexp):
// flash_attention.cu's `flash_fwd_sm90_kernel` and
// `flash_fwd_wide_sm90_kernel` instantiated for __half, in a translation
// unit of their own so that nvcc compiles them beside the bf16 and fp32
// kernels (one process a source, in parallel; `ops/_cuda.py`) instead of
// after them. The kernels, their design and what bounds them are
// flash_attention.cu's.
#define FLASH_ATTENTION_F16
#include "flash_attention.cu"
