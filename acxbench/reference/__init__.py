"""The plain references: straightforward float32 PyTorch written from the
published descriptions of each architecture and of AdamW. They import
nothing of the program and take no tensor that the program made: the
benchmark hands them the weights and tokens it drew itself, and the
program's outputs only to judge them."""
