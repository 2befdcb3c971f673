"""Input pipelines."""
