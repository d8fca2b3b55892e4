"""The shard mesh: ``mesh`` (devices and collectives) and ``routing``."""
