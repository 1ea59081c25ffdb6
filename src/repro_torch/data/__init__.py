"""Token pipeline: numpy batches with a resumable cursor."""
