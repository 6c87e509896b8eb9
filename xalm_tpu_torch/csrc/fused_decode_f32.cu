// The megakernel's nine f32-cache instantiations (the i8, a8 and q4 bodies
// times the (head_dim, Gemma folds) pairs of fused_decode.cu), as a library
// of their own: build.py starts one nvcc per source at once, so these
// compile beside the bf16 and int8 caches' eighteen. The kernel, its notes
// and its entry point are fused_decode.cu's; this library exports
// xq_fused_decode and xq_fused_decode_workspace, and takes cache kind 3.
#define XQ_MK_F32_CACHE 1
#include "fused_decode.cu"
