"""The search driver and its command line."""
