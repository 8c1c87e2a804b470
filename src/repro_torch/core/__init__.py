"""Population trees and weight soups over nested dicts of tensors."""
