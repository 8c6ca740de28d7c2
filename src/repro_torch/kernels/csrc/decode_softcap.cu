// The softcap fragment of decode.cu: its common body (head dims up to 128,
// f32 and bf16, any group up to 32, split over the cache with its merge)
// instantiated with the scores capped, tanh(s / cap) * cap in natural units
// before the mask, as the TPU body `_online_softmax_step` does
// (src/repro/kernels/attn_template.py:136-138) for `decode_core` with
// `softcap` set. Built as a library of its own (entry repro_decode_softcap)
// so that nvcc compiles it beside decode.cu; the uncapped instantiations
// there compile to the code they had without the cap. The body, its bound
// and its design are decode.cu's.
#define REPRO_DECODE_SOFTCAP
#include "decode.cu"
