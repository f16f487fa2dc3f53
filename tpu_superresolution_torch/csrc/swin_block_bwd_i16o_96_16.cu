// K5a (csrc/swin_block_bwd.cu) at ws 16 as the OCAB forward's tail (K8w16,
// csrc/ocab16.cu), padded width 96, padded head dim 16.
#include "swin_block_bwd.cuh"

template int swin_bwd::launch_window<16, 96, 16, swin_bwd::MODE_OFWD>(const swin_bwd::Args&,
                                                                  int, cudaStream_t);
