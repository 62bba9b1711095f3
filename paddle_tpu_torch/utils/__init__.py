"""Host utilities — copies of the jax-free ``paddle_tpu/utils`` modules the
trainer needs: logging, flags and the ``StatSet`` timers."""
