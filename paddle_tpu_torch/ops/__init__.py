"""Ops of the port: the paged-KV attention read paths and their kernels."""
