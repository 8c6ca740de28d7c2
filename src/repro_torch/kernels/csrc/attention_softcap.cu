// The softcap fragment of attention.cu: its causal, window and full bodies
// instantiated with the scores capped, tanh(s / cap) * cap in natural units
// after the scale and before the mask, as the TPU body
// `_online_softmax_step` does (src/repro/kernels/attn_template.py:136-138)
// for a spec with `softcap` set (Gemma 2's attention logit cap). Built as a
// library of its own (entries repro_attention_{causal,window,full}_softcap)
// so that nvcc compiles it beside attention.cu, not after it; the
// uncapped instantiations there compile to the code they had without the
// cap. The bodies, their bounds and their design are attention.cu's.
#define REPRO_ATTENTION_SOFTCAP
#include "attention.cu"
