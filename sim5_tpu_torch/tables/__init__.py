"""Resumable spectral tables and grid-generation drivers.

Port of `sim5_tpu/tables`: the tables live on the host, the rows are
computed on a device (the card unless the caller asks for the CPU)."""

from .spectable import SpectralTable
from .generate import (generate_disk_table, generate_polarized_table,
                       merge_shards, shard_path)
