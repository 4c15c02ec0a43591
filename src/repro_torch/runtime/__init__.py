"""Runtime pieces of the training path: the int8 gradient compression
with error feedback (`compression`)."""
