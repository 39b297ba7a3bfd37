"""Measurement scripts for the port's kernels, run on a GPU with
`python3 -m greptimedb_tpu_torch.tools.<name>`."""
