"""Command line and end-to-end pipelines of the port."""
