"""Config, logging, ``.pth`` interop and plotting for the port."""
