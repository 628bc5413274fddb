"""Training: objectives, the optimizer recipe, tasks and the Trainer
(counterparts of the JAX package's train/)."""
