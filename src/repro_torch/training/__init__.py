"""Training of the port: AdamW with its schedule (``optimizer``), int8
gradient compression with error feedback (``compression``), atomic
manifest-based checkpoints (``checkpoint``) and the loss and train step
(``train_loop``)."""
