// The dK/dV half of flash_bwd.cu (ddpo_flash_bwd_dkv), built as its own
// translation unit so that it compiles in parallel with the dQ half.
#define DDPO_FLASH_BWD_DKV
#include "flash_bwd.cu"
