// K1's and K2's fp16 entries (`decode_attn_i8_f16`, `decode_attn_f16`):
// decode_attention.cu's kernels instantiated for __half, in a translation
// unit of their own so that nvcc compiles them beside the bf16 and fp32
// instances (one process a source, in parallel; `ops/_cuda.py`) instead of
// after them. The kernels, their design and what bounds them are
// decode_attention.cu's.
#define DECODE_ATTENTION_F16
#include "decode_attention.cu"
