"""Runtime pieces of the training path: the int8 gradient compression
with error feedback (`compression`) and the fault-tolerance policies
(`fault_tolerance`); and the spans that mark the port's layers while a
profiler runs (`spans`)."""
