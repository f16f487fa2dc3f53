// K5a (csrc/swin_block_bwd.cu) at ws 7 as the OCAB forward's tail (K8, HAT's
// OCAB core forward, csrc/ocab_bwd.cu), a window a unit, padded width 192,
// padded head dim 32.
#include "swin_block_bwd.cuh"

template int swin_bwd::launch_window<7, 192, 32, swin_bwd::MODE_OFWD>(const swin_bwd::Args&,
                                                                   int, cudaStream_t);
