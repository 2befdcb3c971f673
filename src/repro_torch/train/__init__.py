"""Training: the loss and the step (``train_step``), the checkpointed loop
(``loop``)."""
