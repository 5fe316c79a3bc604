"""Search: the code-resident scan, its kernels, norms codebooks and
recall evaluation."""
