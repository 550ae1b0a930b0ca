// The D > 192 part of flash_fwd_tf32.cu (ddpo::flash_fwd_tf32_wider), built
// as its own translation unit so that it compiles in parallel with the rest.
#define DDPO_FLASH_FWD_TF32_WIDE 2
#include "flash_fwd_tf32.cu"
