// K5a (csrc/swin_block_bwd.cu) at ws 16: K5w16's three token-local
// launches (csrc/swin_block_bwd16.cu), padded width 192, padded head dim 32.
#include "swin_block_bwd.cuh"

template int swin_bwd::launch_window<16, 192, 32, swin_bwd::MODE_FRONT>(const swin_bwd::Args&,
                                                                  int, cudaStream_t);
template int swin_bwd::launch_window<16, 192, 32, swin_bwd::MODE_MID>(const swin_bwd::Args&,
                                                                int, cudaStream_t);
template int swin_bwd::launch_window<16, 192, 32, swin_bwd::MODE_TAIL>(const swin_bwd::Args&,
                                                                 int, cudaStream_t);
