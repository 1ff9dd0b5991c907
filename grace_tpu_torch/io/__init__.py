"""Snapshot, mesh, image and checkpoint IO (PyTorch counterpart of
``grace_tpu.io``)."""
