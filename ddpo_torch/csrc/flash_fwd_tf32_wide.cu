// The 128 < D <= 192 part of flash_fwd_tf32.cu (ddpo::flash_fwd_tf32_wide),
// built as its own translation unit so that it compiles in parallel with the
// rest.
#define DDPO_FLASH_FWD_TF32_WIDE 1
#include "flash_fwd_tf32.cu"
