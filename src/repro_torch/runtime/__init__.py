"""Runtime pieces of the training path: the int8 gradient compression
with error feedback (`compression`) and the fault-tolerance policies
(`fault_tolerance`)."""
