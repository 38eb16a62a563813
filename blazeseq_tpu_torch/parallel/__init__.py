"""The padded-batch step and the overlapped host-to-device chunk feed."""
