"""Training of the port: losses, LR schedules, freezing, the engine
(optimizer, train / eval steps, Trainer) and checkpoints."""
