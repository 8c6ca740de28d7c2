// The lse fragment of attention.cu: its causal, window and full bodies
// instantiated to also store each row's log-sum-exp, f32 (B, Hq, Sq), as
// JAX's flash forward `_flash_fwd_impl` returns it
// (src/repro/models/attention.py:172) for its backward: the training
// forward, whose backward is attention_bwd.cu. Built as a library of its
// own (entries repro_attention_{causal,window,full}_lse) so that nvcc
// compiles it beside attention.cu, not after it; the instantiations without
// the flag compile to the code they had without it. Head dims up to 128,
// uncapped. The bodies, their bounds and their design are attention.cu's.
#define REPRO_ATTENTION_LSE
#include "attention.cu"
