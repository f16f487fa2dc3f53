// K5a (csrc/swin_block_bwd.cu) at ws 8 past the block kernel's widths:
// K5r's three token-local launches (csrc/swin_block_bwd16.cu), padded
// width 256, padded head dim 32 (SwinIR-L's C 240 in 8 heads of 30).
#include "swin_block_bwd.cuh"

template int swin_bwd::launch_window<8, 256, 32, swin_bwd::MODE_FRONT>(const swin_bwd::Args&,
                                                                 int, cudaStream_t);
template int swin_bwd::launch_window<8, 256, 32, swin_bwd::MODE_MID>(const swin_bwd::Args&,
                                                               int, cudaStream_t);
template int swin_bwd::launch_window<8, 256, 32, swin_bwd::MODE_TAIL>(const swin_bwd::Args&,
                                                                int, cudaStream_t);
