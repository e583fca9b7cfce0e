"""FCN inference and npz weight loading."""
