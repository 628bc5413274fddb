"""Models: ResNet50-TSM, BERT, the two-stream chapter head, Seq2Seq."""
