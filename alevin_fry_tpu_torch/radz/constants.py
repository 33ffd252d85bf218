"""Constants (reference: src/constants.rs, src/em.rs, src/quant.rs)."""

# permit_freq.bin format version (reference: src/constants.rs:10)
PERMIT_FILE_VER = 1

# the high bit of a u32 marks forward orientation in compressed_ori_refid
# (reference libradicl utils, used at src/convert.rs:443-444)
ORI_BIT_U32 = 0x8000_0000       # bit 31: orientation flag
REF_ID_MASK_U32 = 0x7FFF_FFFF   # low 31 bits: reference id

# fragments of this length and longer are not written to ATAC BED output
# (reference: src/constants.rs:11)
MAX_ATAC_FRAG_LEN = 2000

# ATAC genomic bin size in bp (reference: src/atac/cellfilter.rs:367)
ATAC_BIN_SIZE = 100_000

# cells with fewer than this many records take the winner-take-all fast
# path whatever the resolution (reference: src/quant.rs:433)
SMALL_CELL_FAST_THRESHOLD = 100

# EM hyper-parameters (reference: src/em.rs:28-34)
MIN_OUTPUT_ALPHA = 0.01
ALPHA_CHECK_CUTOFF = 1e-2
EM_MIN_ITER = 2
EM_MAX_ITER = 100
EM_REL_DIFF_TOLERANCE = 1e-2
