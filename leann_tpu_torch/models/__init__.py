"""Models that run on the device beside the search engines."""
