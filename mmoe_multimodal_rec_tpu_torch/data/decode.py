"""Stored image layout shared by the serving path: each image is 196 patch
rows of 768 bytes, the (14 x 14 grid, C*16*16) patchification in
(C, ph, pw) row-major order (ref newpatch.py:102-104)."""

PATCH_ROWS = 196
PATCH_DIM = 768
PATCH_SHAPE = (PATCH_ROWS, PATCH_DIM)
