"""The benchmark of greptimedb_tpu_torch: TSBS cpu-only dashboards over
Arrow Flight, on one H100. README.md says how it is laid out and run."""
