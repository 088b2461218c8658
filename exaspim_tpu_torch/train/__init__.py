"""Training: train state and steps, the Trainer, checkpoints, and the
cache-only training entry (``python -m exaspim_tpu_torch.train.train_bm4dnet``)."""
