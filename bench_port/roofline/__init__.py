"""The card's peaks and the kernels' least bytes and operations."""
