"""Config, logging, devices, checkpoints and ``.pth`` interop, plotting
for the port."""
